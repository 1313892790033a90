"""Seconds of a ``production`` call (``from_features`` and ``condensed()``)
in the traced window, from its start until its last device operation
ends."""


def read(run):
    return run.call_s("production")
