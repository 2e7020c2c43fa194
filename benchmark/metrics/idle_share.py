"""The share of the traced window in which the card ran no kernel, copy
or set, averaged over the run's cards, %."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share(run.cards)
