"""Seconds of the port's permutation-order draw a study in the traced
window (its ``engine.orders`` span: the CPU draw, the copy to the device,
the argsort), from the span's start until it or its last device operation
ends."""

from perfbench import spans


def read(run):
    return spans.study_seconds(run, "engine.orders")
