"""Seconds of the PCoA operator's products a study in the traced window
(its ``operator.matvec`` spans), each from its start until it or its last
device operation ends."""

from perfbench import spans


def read(run):
    return spans.study_seconds(run, "operator.matvec")
