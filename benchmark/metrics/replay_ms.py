"""Mean device time of the fused pipeline's graph replay per prove (the
span `fused.replay`, plonk/device_prover.py::_fused_prove: the copies
into the graph's inputs and the replay, timed by CUDA events on the
card's stream), device clock, ms."""

from harness import spans


def read(run):
    return spans.read(run, "fused.replay", device=True)
