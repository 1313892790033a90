"""Seconds from the process's start until the window opens: imports, the
inputs, the port's library (built on a checkout's first run), the warm-up
study."""


def read(run):
    return run.setup_s
