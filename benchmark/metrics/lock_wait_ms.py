"""Mean wait for the card's prove lock per prove (the span
`fused.lock_wait`, plonk/device_prover.py::_fused_prove: from asking for
ctx.lock to holding it), host clock, ms."""

from harness import spans


def read(run):
    return spans.read(run, "fused.lock_wait")
