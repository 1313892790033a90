"""The ``permanova`` calls' least time (``perfbench/work/``) over the
device-busy time of the work they launched in the traced window, in
percent."""


def read(run):
    return run.roofline("permanova")
