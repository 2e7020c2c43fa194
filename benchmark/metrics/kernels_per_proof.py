"""Kernels the card ran in the traced window per proof answered in it."""


def read(run):
    if run.trace is None or not run.traced_proofs:
        return None
    return run.trace.kernel_events / run.traced_proofs
