"""The 95th percentile of every request of the window, from the moment
it is sent to the proof's bytes in hand (commit + prove), host clock, ms."""

import numpy as np


def read(run):
    lat = [(r.done - r.sent) * 1e3 for r in run.requests]
    return float(np.percentile(lat, 95)) if lat else None
