"""One run of one cell: set-up, the measured window, the reading of the
device's peak memory, the release of the program's state, the check
against the plain reference, and the result's line."""

from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass

from harness import trace as trace_mod
from harness import window as window_mod
from harness import work

FORBIDDEN = ("jax", "jaxlib", "flax", "qzk_tpu")


@dataclass
class Run:
    """What a metric's reader reads (benchmark/metrics/<name>.py)."""
    setup_s: float
    window_s: float
    requests: list  # window.Request, in the order sent
    leaves_per_request: int
    cards: int
    trace: trace_mod.TraceSummary | None
    traced_proofs: int
    traced_work: tuple | None  # (Poseidon permutations, bytes) of the traced proofs
    rates: dict | None  # the card's peak rates (work.card_rates)

    @property
    def answered(self) -> list:
        return [r for r in self.requests if r.error is None]

    def phase_mean_ms(self, prefix: str):
        """Mean milliseconds of the program's prove phases whose name starts
        with `prefix`, over every such phase the window's requests marked."""
        spans = [(end - start) * 1e3 for r in self.requests if r.marks is not None
                 for name, start, end in r.marks.phases() if name.startswith(prefix)]
        return sum(spans) / len(spans) if spans else None


def answered_by_thirds(window) -> list:
    """Answers a second in each third of the window, by the time each came."""
    third = window.seconds / 3
    counts = [0, 0, 0]
    for r in window.requests:
        if r.error is None:
            counts[min(2, int((r.done - window.start) / third))] += 1
    return [n / third for n in counts]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, process_start: float,
             cache_dir: str) -> tuple:
    """Returns (result, lines for standard error, the names of the cell's
    metrics that read nothing)."""
    import torch

    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    steps = window_mod.Marks()
    runner = cell.runner.Runner(cell, seed, devices, os.path.join(cache_dir, "circuits"), trace)
    runner.setup(steps)
    for d in devices:
        torch.cuda.synchronize(d)
    t = cell.traffic
    profiler = trace_mod.Profiler(os.path.join(cache_dir, "trace", "window.json")) if trace else None
    window = window_mod.closed_loop(runner.send, runner.callers, seconds, with_marks=trace,
                                    profiler=profiler, lead=float(t.get("trace_lead_s", 0)),
                                    length=float(t.get("trace_seconds", seconds)))
    setup_s = window.start - process_start
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    keys = runner.program_keys()
    summary = rates = None
    if trace and window.traced_end is not None:
        phases = [p for r in window.requests if r.marks is not None for p in r.marks.phases()]
        summary = trace_mod.summarize(profiler.export(), profiler.sync_perf,
                                      window.traced_start, window.traced_end, phases)
        rates = work.card_rates()
    runner.close()
    gc.collect()
    torch.cuda.empty_cache()

    t_check = time.perf_counter()
    found = runner.check(window, keys)
    t_check = time.perf_counter() - t_check
    run = Run(setup_s=setup_s, window_s=window.seconds, requests=window.requests,
              leaves_per_request=runner.leaves_per_request, cards=len(devices), trace=summary,
              traced_proofs=found["traced_proofs"], traced_work=found["traced_work"],
              rates=rates)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    unread = [m.name for m in (cell.per_layer if trace else cell.end_to_end)
              if m.name not in metrics]
    checks = found["checks"]
    failed = found["failed_requests"]
    correct = all(v <= limit for v, limit in checks.values()) and bool(run.answered)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(devices),
              "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(window.requests), "failed": failed,
              "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.mean_busy_s(len(devices))
        device["window_s"] = summary.window_s
        ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(summary.idle_by_phase.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, v[0]] for n, v in ops],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    errors = sorted({r.error for r in window.requests if r.error})
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    lines = [f"set-up, before the runner: {steps.start - process_start:.3f} s"]
    lines += [f"set-up, {name}: {end - start:.3f} s" for name, start, end in steps.phases()]
    lines += [f"window: {window.seconds:.3f} s; check: {t_check:.3f} s"]
    lines += ["answered a second, by thirds of the window: "
              + ", ".join(f"{v:.3f}" for v in answered_by_thirds(window))]
    lines += [f"request failed: {e}" for e in errors[:5]]
    lines += [f"verified in full: {found['verified']}"]
    lines += [f"check {name}: {v} (limit {limit})" for name, (v, limit) in checks.items()]
    return result, lines, unread
