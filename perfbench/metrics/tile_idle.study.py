"""The share of the traced window in which the device was idle while a
permutation tile (``engine.tile``: its inverse orders, their check, which
synchronises, and its reductions) was the innermost span of the port open
when the gap began, in percent."""

from perfbench import spans


def read(run):
    return spans.idle_share(run, "engine.tile")
