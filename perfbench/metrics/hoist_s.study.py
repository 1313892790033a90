"""Seconds a study of the traced window under the port's session hoists
(its ``hoist:<artifact>`` spans: ``gram``, ``condensed``, ``ranks``,
``operator``, ``coords``, ...), each from its start until it or its last
device operation ends, counted once where they overlap: a hoist built
inside another (the operator inside the coordinates) lies within it."""

from perfbench import spans
from perfbench import trace as tracing

PREFIX = "hoist:"


def read(run):
    program = spans.of(run)
    if program is None or not program.studies:
        return None
    hoists = tracing.merge(
        (lo, max([hi] + [b for _, b in work]))
        for name, ivs in program.spans.items() if name.startswith(PREFIX)
        for (lo, hi), work in zip(ivs, program.work[name]))
    if not hoists:
        return None
    return sum(hi - lo for lo, hi in hoists) / program.studies
