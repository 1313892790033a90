"""Seconds of an ``anosim`` call in the traced window, from its start until
its last device operation ends."""


def read(run):
    return run.call_s("anosim")
