"""The device allocator's peak from set-up to the window's end, GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
