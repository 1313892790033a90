"""The window's seconds over the studies completed in it: every study and
every second of the window, not a median of studies."""


def read(run):
    return run.window_s / run.studies if run.studies else None
