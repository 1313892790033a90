"""The share of the traced window in which the device was idle while one
of the PCoA operator's products (``operator.matvec``) was the innermost
span of the port open when the gap began, in percent."""

from perfbench import spans


def read(run):
    return spans.idle_share(run, "operator.matvec")
