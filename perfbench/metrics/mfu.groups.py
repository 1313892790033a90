"""The whole study's share of the chip's peak in the cells of the grouping
tests, in percent: the least time of one study's calls
(``perfbench/work/``) over the untraced window's seconds a study, as
``mfu.study`` reads it in the cells that list it."""


def read(run):
    least = run.least_study_s
    if least is None or not run.studies:
        return None
    return 100.0 * least * run.studies / run.window_s
