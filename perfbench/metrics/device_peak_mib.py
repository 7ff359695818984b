"""torch.cuda.max_memory_allocated over the window (reset at its start),
in MiB: the prestaged frames, the program's buffers and what the window
allocates."""


def read(w):
    return w.peak_bytes / 2 ** 20 if w.peak_bytes else None
