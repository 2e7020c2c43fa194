"""Mean time of an aggregation chunk's fill per chunk prove (the span
`aggregation.fill`, models/wormhole/aggregator.py::_fill: the child
proofs and their verifier data set into the chunk circuit's partial
witness), host clock, ms; reads nothing in a window without the span."""

from harness import spans


def read(run):
    return spans.read(run, "aggregation.fill")
