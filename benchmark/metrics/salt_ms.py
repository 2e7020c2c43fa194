"""Mean time of the zk blinding stream's threefry draws per prove,
summed (the spans `blinding.draw`, plonk/prover.py::blinding_stream:
the blind block and the three leaf salts), host clock, ms."""

from harness import spans


def read(run):
    return spans.read(run, "blinding.draw")
