"""The program's spans of the window's requests (qzk_tpu_torch's
utils/spans.py: the program records them for each request given a
timer, here each request's Marks), reduced to a mean per prove.  A
program without spans, or a window whose requests hold none of the
name, reads nothing (None)."""

from __future__ import annotations


def request_spans(run) -> list:
    """Every span of every request of the window that carried marks; []
    when the program records no spans."""
    try:
        from qzk_tpu_torch.utils.spans import spans_of
    except ImportError:
        return []
    return [s for r in run.requests if r.marks is not None for s in spans_of(r.marks)]


def mean_per_prove_ms(spans: list, name: str, device: bool = False):
    """The summed milliseconds of the spans `name` (each span's device
    time with `device`: its `device_ms`), over the proves recorded (the
    spans named "prove": a leaf prove, or one chunk prove of an
    aggregation); None when no span `name` was recorded, or, with
    `device`, none timed its device work."""
    proves = sum(s.name == "prove" for s in spans)
    named = [s for s in spans if s.name == name]
    if not named or not proves:
        return None
    if device:
        ms = [s.device_ms for s in named if s.device_ms is not None]
        return sum(ms) / proves if ms else None
    return 1e3 * sum(s.end - s.start for s in named) / proves


def read(run, name: str, device: bool = False):
    return mean_per_prove_ms(request_spans(run), name, device)
