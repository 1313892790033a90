"""The whole study's share of the chip's peak, in percent: the least time
of one study's calls (``perfbench/work/``) over the untraced window's
seconds a study. A kernel taken off the path leaves its roofline silent;
this share still bounds it."""


def read(run):
    least = run.least_study_s
    if least is None or not run.studies:
        return None
    return 100.0 * least * run.studies / run.window_s
