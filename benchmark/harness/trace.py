"""The traced window through torch.profiler, and its reduction: each
card's busy time (the union of its kernel, memcpy and memset intervals),
device time by kernel, and the idle gaps named by the host phase that was
running (the arithmetic of the port's tools/profile_prover.py).  The
chrome trace goes to a fixed file of the benchmark's cache and is deleted
once read."""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "bench.clock_sync"


def kernel_name(name: str) -> str:
    """A kernel's name without return type, template arguments and
    parameters, so that every instantiation groups together."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Profiler:
    """torch.profiler over CPU and CUDA activity, started and stopped by
    the window.  An annotation made at the start, beside a host-clock
    reading (sync_perf), maps the host clock onto the trace's."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.sync_perf = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        with record_function(SYNC):
            self.sync_perf = time.perf_counter()

    def stop(self) -> None:
        self.prof.stop()

    def export(self) -> list:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: dict  # card -> seconds
    kernels: dict  # kernel name -> [seconds, launches]
    kernel_events: int
    idle_by_phase: dict = field(default_factory=dict)  # host phase -> idle seconds

    def mean_busy_s(self, cards: int) -> float:
        return sum(self.busy_s.get(c, 0.0) for c in range(cards)) / cards

    def idle_share(self, cards: int) -> float:
        return 1.0 - self.mean_busy_s(cards) / self.window_s


def summarize(events: list, sync_perf: float, t0: float, t1: float,
              phases: list) -> TraceSummary:
    """Reduce a chrome trace to the traced window [t0, t1] (host clock).
    `phases` holds (name, start, end) on the host clock, for naming each
    card's idle gaps."""
    sync = [e for e in events if e.get("name") == SYNC and e.get("ph") == "X"]
    if not sync:
        raise RuntimeError("the trace lacks its clock-sync annotation")
    offset = sync[0]["ts"] - sync_perf * 1e6  # trace us = perf s * 1e6 + offset
    w0, w1 = t0 * 1e6 + offset, t1 * 1e6 + offset
    per_card = defaultdict(list)
    kernels = defaultdict(lambda: [0.0, 0])
    n_kernels = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat", "") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if t <= s:
            continue
        card = int(e.get("args", {}).get("device", e.get("pid", 0)))
        per_card[card].append((s, t))
        if e["cat"] == "kernel":
            k = kernels[kernel_name(e.get("name", "?"))]
            k[0] += (t - s) / 1e6
            k[1] += 1
            n_kernels += 1
    busy = {card: union_us(iv) / 1e6 for card, iv in per_card.items()}

    starts = sorted((s * 1e6 + offset, e * 1e6 + offset, n) for n, s, e in phases)
    keys = [p[0] for p in starts]
    idle = defaultdict(float)
    unnamed = "between requests" if phases else "no phase marks"
    for iv in per_card.values():
        prev = w0
        for s, t in sorted(iv) + [(w1, w1)]:
            if s > prev:
                mid = (s + prev) / 2
                i = bisect.bisect_right(keys, mid)
                names = {n for a, b, n in starts[max(0, i - 64) : i] if a <= mid < b}
                idle["|".join(sorted(names)) or unnamed] += (s - prev) / 1e6
            prev = max(prev, t)
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy, kernels=dict(kernels),
                        kernel_events=n_kernels, idle_by_phase=dict(idle))
