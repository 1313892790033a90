"""The device allocator's peak over the window (reset as it opens), in GB
of 1e9 bytes: the resident inputs and the one study's outputs the check
keeps included."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
