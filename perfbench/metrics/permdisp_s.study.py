"""Seconds of a ``permdisp`` call in the traced window, its ordination
included, from its start until its last device operation ends."""


def read(run):
    return run.call_s("permdisp")
