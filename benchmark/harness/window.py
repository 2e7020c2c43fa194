"""The measured window: closed-loop callers, each sending its next
request when its last one is answered, until --seconds have passed; the
window closes when the last request sent has been answered, so every
rate is all the work over all the time.  With a profiler, the first
caller starts it before its first request sent `lead` seconds into the
window and stops it after its first request answered `length` seconds
after that: the traced window is whole requests of that caller, and
ends before the profiler's own stop, which can take seconds."""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field


class Marks:
    """The program's phase-timer protocol (mark(name) at the end of each
    phase), kept on the host clock: (name, perf_counter) in order."""

    def __init__(self):
        self.start = time.perf_counter()
        self.marks: list = []

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))

    def phases(self) -> list:
        """[(name, start, end)] in order."""
        out, prev = [], self.start
        for name, t in self.marks:
            out.append((name, prev, t))
            prev = t
        return out


@dataclass
class Request:
    caller: int
    seq: int
    sent: float
    done: float = 0.0
    answer: object = None
    error: str | None = None
    marks: Marks | None = None
    traced: bool = False


@dataclass
class Window:
    start: float
    end: float
    requests: list = field(default_factory=list)
    traced_start: float | None = None
    traced_end: float | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


def closed_loop(send, callers: int, seconds: float, with_marks: bool,
                profiler=None, lead: float = 0.0, length: float = 0.0) -> Window:
    """Run send(caller, seq, marks) -> answer from `callers` threads for
    `seconds`.  seq numbers the requests in the order they are sent."""
    counter = itertools.count()
    lock = threading.Lock()
    start = time.perf_counter()
    window = Window(start=start, end=start)
    stop_at = start + seconds

    def loop(caller: int) -> None:
        while time.perf_counter() < stop_at:
            if caller == 0 and profiler is not None:
                if window.traced_start is None and time.perf_counter() >= start + lead:
                    profiler.start()
                    window.traced_start = time.perf_counter()
            with lock:
                seq = next(counter)
            req = Request(caller, seq, time.perf_counter(),
                          marks=Marks() if with_marks else None)
            req.traced = window.traced_start is not None and window.traced_end is None
            if req.marks is not None:
                req.marks.start = req.sent
            try:
                req.answer = send(caller, seq, req.marks)
            except Exception as e:  # a failed request is counted, and the callers go on
                req.error = f"{type(e).__name__}: {e}"
            req.done = time.perf_counter()
            with lock:
                window.requests.append(req)
            if (caller == 0 and profiler is not None and window.traced_start is not None
                    and window.traced_end is None
                    and (req.done >= window.traced_start + length or req.done >= stop_at)):
                window.traced_end = time.perf_counter()
                profiler.stop()

    # the first caller runs on this thread, which also starts and stops
    # the profiler: the profiler's CUDA client registers on it
    threads = [threading.Thread(target=loop, args=(i,), name=f"caller{i}")
               for i in range(1, callers)]
    for t in threads:
        t.start()
    loop(0)
    for t in threads:
        t.join()
    window.end = time.perf_counter()
    window.requests.sort(key=lambda r: r.seq)
    return window
