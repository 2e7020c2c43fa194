"""Spans of the program's prove and aggregation requests, on the host
clock (time.perf_counter).

A request opens where an entry point is given a timer (the `timer=`
protocol: mark(name) at the end of each phase): plonk.prover.prove and
aggregator.aggregate_to_tree / aggregate_level.  A prove inside an open
aggregation joins its request.  Every span of a request carries the
request's id, its parent span and a few attributes (`level`, `chunk`,
`chunks` and `card` on aggregation spans, `children` and `degree_bits`
on a chunk, `children` and `values` on a fill, `card` on a prove,
`values` and `set_calls` on the generators, `degree_bits`, `bytes` and
`evicted` on a context build; set_attrs adds those known only at a
span's end); a span opened with `device=` also
times its work on that card with a pair of CUDA events, read as
`device_ms` when first asked for, after the prove's own download has
waited for the card.

The phases a prove marks are its top-level spans: Phases.mark(name)
ends the phase begun at the previous mark (or at the prove's start) and
then calls the caller's timer.mark(name), at the same code point as
without spans.  A prove that fans out records spans and forwards no
marks: its chunk proves, in other threads, pass no timer.

The request lives in a ContextVar, so each thread has its own; a task
handed to a thread pool runs in contextvars.copy_context() to join the
request of the thread that submitted it.  With no request open, span()
is one ContextVar.get() and returns a shared object that does nothing:
no clock is read and nothing is kept.  spans_of(timer) gives a timer's
spans back, kept as long as the caller keeps the timer.  While the torch
profiler records, each span is also a record_function range of its
name (phases are not: their names are known only at their ends), so a
chrome trace holds the program's spans on the kernels' clock.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
import weakref

# (request, innermost open span) of this thread's context, or None
_STATE: contextvars.ContextVar = contextvars.ContextVar("qzk_spans", default=None)
_REQUEST_IDS = itertools.count(1)
_BY_TIMER: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_BY_TIMER_LOCK = threading.Lock()


class Span:
    """One recorded span: `name`, `start` and `end` (perf_counter
    seconds), `parent` (a Span, or None at a request's root), `request`
    (the request's id) and `attrs`."""

    __slots__ = ("name", "start", "end", "parent", "request", "attrs", "_events",
                 "_device_ms")

    def __init__(self, name, start, parent, request, attrs, events=None):
        self.name, self.start, self.end = name, start, None
        self.parent, self.request, self.attrs = parent, request, attrs
        self._events, self._device_ms = events, None

    @property
    def device_ms(self):
        """Milliseconds of the span's work on its card (CUDA events), or
        None for a span that timed no device work."""
        if self._events is not None:
            begin, end = self._events
            end.synchronize()
            self._device_ms = begin.elapsed_time(end)
            self._events = None
        return self._device_ms


class _Request:
    __slots__ = ("id", "spans")

    def __init__(self, spans: list):
        self.id = next(_REQUEST_IDS)
        self.spans = spans


class _Off:
    """What span() returns with no request open; entering gives None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded; entering gives a Phases object."""

    __slots__ = ("_request", "_parent", "_timer", "_name", "_attrs", "_device", "_span",
                 "_token", "_range")

    def __init__(self, request, parent, timer, name, attrs, device):
        self._request, self._parent, self._timer = request, parent, timer
        self._name, self._attrs, self._device = name, attrs, device

    def __enter__(self):
        import torch

        # the host clock is read before the start event is recorded and
        # after the end event is, so that the device's interval lies in
        # the host's
        start = time.perf_counter()
        events = None
        if self._device is not None and torch.device(self._device).type == "cuda":
            stream = torch.cuda.current_stream(self._device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self._name)
            self._range.__enter__()
        span = Span(self._name, start, self._parent, self._request.id, self._attrs, events)
        self._request.spans.append(span)
        self._span = span
        self._token = _STATE.set((self._request, span))
        return Phases(self._request, span, self._timer)

    def __exit__(self, *exc):
        import torch

        span = self._span
        if span._events is not None:
            span._events[1].record(torch.cuda.current_stream(self._device))
        span.end = time.perf_counter()
        _STATE.reset(self._token)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Phases:
    """The top-level phases of an open span (a prove's), and the caller's
    timer, if it passed one, to forward each phase's mark to."""

    __slots__ = ("_request", "_span", "_timer", "_since")

    def __init__(self, request, span, timer):
        self._request, self._span, self._timer = request, span, timer
        self._since = span.start

    def mark(self, name: str) -> None:
        """End the phase `name` (begun at the previous mark) here."""
        now = time.perf_counter()
        phase = Span(name, self._since, self._span, self._request.id, {})
        phase.end = self._since = now
        self._request.spans.append(phase)
        if self._timer is not None:
            self._timer.mark(name)


def _attrs(level, chunk, chunks, card) -> dict:
    out = {"level": level, "chunk": chunk, "chunks": chunks,
           "card": None if card is None else str(card)}
    return {k: v for k, v in out.items() if v is not None}


def span(name: str, *, timer=None, device=None, level=None, chunk=None, chunks=None,
         card=None, attrs=None):
    """A context manager that records the span `name` in the open
    request, or opens a request when none is and `timer` is given (the
    span is then its root).  Entering gives a Phases object, whose
    mark(name) ends a top-level phase and forwards it to `timer`, or None
    when no request is open.  `device`: the card whose current stream
    the span's work runs on, timed by CUDA events (ignored off a card).
    `attrs`: further attributes of the span, a dict."""
    state = _STATE.get()
    if state is None:
        if timer is None:
            return _OFF
        spans: list = []
        try:
            with _BY_TIMER_LOCK:
                spans = _BY_TIMER.setdefault(timer, spans)
        except TypeError:  # a timer that takes no weak reference keeps no spans
            pass
        request, parent = _Request(spans), None
    else:
        request, parent = state
    return _Open(request, parent, timer, name,
                 {**_attrs(level, chunk, chunks, card), **(attrs or {})}, device)


def in_request() -> bool:
    """Whether this thread's context has a request open."""
    return _STATE.get() is not None


def set_attrs(**attrs) -> None:
    """Add `attrs` to this thread's innermost open span: attributes known
    only once its work is done.  Nothing with no request open."""
    state = _STATE.get()
    if state is not None:
        state[1].attrs.update(attrs)


class _Locked:
    __slots__ = ("_lock", "_wait", "_held", "_open")

    def __init__(self, lock, wait, held):
        self._lock, self._wait, self._held = lock, wait, held

    def __enter__(self):
        with span(self._wait):
            self._lock.acquire()
        try:
            self._open = span(self._held)
            self._open.__enter__()
        except BaseException:
            self._lock.release()
            raise
        return self._lock

    def __exit__(self, *exc):
        try:
            self._open.__exit__(*exc)
        finally:
            self._lock.release()
        return False


def locked(lock, wait: str, held: str):
    """`lock` as a context manager, with the spans `wait` (asking for it
    until holding it) and `held` (holding it until releasing it) when a
    request is open; `lock` itself otherwise."""
    if _STATE.get() is None:
        return lock
    return _Locked(lock, wait, held)


def spans_of(timer) -> list:
    """Every span recorded in the requests that `timer` was passed to, in
    the order they began (a phase: in the order it ended)."""
    try:
        with _BY_TIMER_LOCK:
            return list(_BY_TIMER.get(timer, ()))
    except TypeError:  # no weak reference, so no spans kept
        return []
