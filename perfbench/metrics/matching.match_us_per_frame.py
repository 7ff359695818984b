"""The descriptor matching kernel's device time a frame: the summed
traced durations of the launches whose kernel name holds `hamming_match`
(csrc/hamming_match.cu: a tiles and a resolve launch each match call, the
stereo match and every projective attempt of the retry ladder) over the
traced slice's frames, in us.  A frame makes at least one stereo and one
projective call; the ladder's later attempts vary the count from frame to
frame, and every call has the same shape, so any count of at least 2
launches a frame is read.  Nothing is read below that, as in a program
without the kernel."""

SYMBOL = "hamming_match"


def read(w):
    t = w.trace
    if t is None or t.frames <= 0:
        return None
    durs = [d for name, _, d in t.kernels if SYMBOL in name]
    if len(durs) < 2 * t.frames:
        return None
    return 1e-3 * sum(durs) / t.frames
