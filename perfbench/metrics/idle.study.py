"""The share of the traced window in which no kernel, memcpy or memset ran
on the device, in percent."""


def read(run):
    if not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.busy_window_s)
