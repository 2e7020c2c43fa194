"""Mean hold of the card's prove lock per prove (the span
`fused.lock_held`, plonk/device_prover.py::_fused_prove: from holding
ctx.lock to releasing it; the replay, the download, the PoW check and
the query assembly), host clock, ms.  One card serves at most 1000 /
this many proofs a second."""

from harness import spans


def read(run):
    return spans.read(run, "fused.lock_held")
