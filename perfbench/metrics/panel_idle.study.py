"""The share of the traced window in which the device was idle while one
of the production's panels (``dist.panel``: its launch, its running sums,
its strip's selection) was the innermost span of the port open when the
gap began, in percent."""

from perfbench import spans


def read(run):
    return spans.idle_share(run, "dist.panel")
