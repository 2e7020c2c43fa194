"""Mean time of the fused phase's upload per prove (the span
`fused.upload`, plonk/device_prover.py::_fused_prove: the wire matrix
assembled on the card and the public-input hash, before the card's prove
lock), host clock, ms."""

from harness import spans


def read(run):
    return spans.read(run, "fused.upload")
