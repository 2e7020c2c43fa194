"""Leaf proofs answered over all the seconds of the window, host clock."""


def read(run):
    return len(run.answered) / run.window_s
