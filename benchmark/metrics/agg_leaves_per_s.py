"""Leaves aggregated (the leaves of each root answered) over all the
seconds of the window, host clock."""


def read(run):
    return len(run.answered) * run.leaves_per_request / run.window_s
