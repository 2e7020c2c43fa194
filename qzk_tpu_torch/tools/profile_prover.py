"""Device profile of one warm prove on the card, through torch.profiler
(counterpart of the JAX package's tools/profile_prover.py).

    python3 -m qzk_tpu_torch.tools.profile_prover [--top 25]
        [--outdir DIR] [--circuit wormhole|small] [--device cuda]

Builds the zk Wormhole circuit (``standard_recursion_zk_config()``,
``synthetic_circuit_inputs()``), proves once to warm up (on the card
this captures the context's CUDA graph) and verifies, then proves
once more inside ``torch.profiler.profile`` with CPU and CUDA
activities, the prove wrapped in the range ``qzk_prove``.  It exports
the chrome trace to DIR/prove_fused.json, prints summarize()'s table,
and one JSON line: the device time by kernel name, the count of
device events and of kernels, the device's busy time (the union of its
events' intervals), the window (the ``qzk_prove`` range) and the idle
share of that window, beside the card's name and power limit; and the
device's idle gaps named by the innermost program span (utils/spans.py,
whose spans the profiler records as ``record_function`` ranges) running
on the host at each gap's midpoint.
``--circuit small`` proves a 2^3-row circuit instead, and ``--device
cpu`` runs on the CPU (plumbing only: the trace then holds no device
lane, and the record says "device": "cpu").
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

WINDOW = "qzk_prove"
# torch.profiler's categories of work that runs on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_lanes(meta: dict) -> set:
    """pids whose process_name marks a device lane ("GPU 0", a CUDA or
    device lane); empty when the trace names none."""
    return {pid for pid, name in meta.items()
            if any(k in name.lower() for k in ("gpu", "cuda", "device"))}


def _is_device(event: dict, lanes: set) -> bool:
    """A device event: torch.profiler's kernel, memcpy and memset
    categories; an event without a category counts when it lies on a
    device lane.  Annotations and host categories do not count."""
    cat = event.get("cat", "")
    if cat:
        return cat in DEVICE_CATS
    return event.get("pid") in lanes


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list: every instantiation of a kernel groups together."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    out, depth = [], 0
    for c in name:
        if c == "<":
            depth += 1
        elif c == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(c)
    return "".join(out).strip() or name


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals, in ms (the
    trace's times are microseconds)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def load_trace(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def idle_by_span(ranges, intervals, w0: float, w1: float) -> dict:
    """Idle milliseconds of the window [w0, w1] (trace microseconds) by
    the innermost of `ranges` ((start, end, name), the program's spans)
    holding each gap's midpoint: the device is idle between the
    `intervals` it is busy.  A gap inside no range is "outside any
    span"."""
    idle = defaultdict(float)
    prev = w0
    for s, t in sorted(intervals) + [(w1, w1)]:
        if s > prev:
            mid = (s + prev) / 2
            holding = [r for r in ranges if r[0] <= mid < r[1]]
            name = max(holding, key=lambda r: (r[0], -r[1]))[2] if holding else \
                "outside any span"
            idle[name] += (s - prev) / 1e3
        prev = max(prev, t)
    return dict(idle)


def summarize(trace_path: str, top: int = 25, out=print) -> dict:
    """The device profile of a chrome trace: device time by kernel name,
    event and kernel counts, busy time, window and idle share, and the
    idle time by the innermost program span (idle_by_span; the host's
    ``user_annotation`` ranges other than the window).  The window is
    the ``qzk_prove`` range when the trace has one, else the span of all
    its timed events; busy time is the union of the device events'
    intervals within it."""
    events = load_trace(trace_path)
    meta = {e["pid"]: e.get("args", {}).get("name", "") for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    lanes = _device_lanes(meta)
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in timed
               if e.get("name") == WINDOW and e.get("cat", "") == "user_annotation"]
    if windows:
        w0, w1 = windows[0]["ts"], windows[0]["ts"] + windows[0]["dur"]
    elif timed:
        w0 = min(e["ts"] for e in timed)
        w1 = max(e["ts"] + e["dur"] for e in timed)
    else:
        w0 = w1 = 0.0
    by_name = defaultdict(lambda: [0.0, 0])
    intervals, n_kernels = [], 0
    for e in timed:
        if not _is_device(e, lanes):
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        name = kernel_name(e.get("name", "?"))
        by_name[name][0] += (t - s) / 1e3
        by_name[name][1] += 1
        intervals.append((s, t))
        n_kernels += e.get("cat", "kernel") == "kernel"
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for _, (ms, _) in rows)
    window_ms = (w1 - w0) / 1e3
    busy_ms = _union_ms(intervals)
    ranges = [(e["ts"], e["ts"] + e["dur"], e.get("name", "?")) for e in timed
              if e.get("cat") == "user_annotation" and e.get("name") != WINDOW]
    idle = sorted(idle_by_span(ranges, intervals, w0, w1).items(), key=lambda kv: -kv[1])
    rec = {
        "window_ms": window_ms,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / window_ms if window_ms else None,
        "device_ms": device_ms,
        "device_events": len(intervals),
        "kernels": n_kernels,
        "by_name": [[name, ms, count] for name, (ms, count) in rows[:top]],
        "idle_by_span": [[name, ms] for name, ms in idle],
    }
    out(f"device lanes: {sorted(meta[p] for p in lanes) or 'none named'}")
    out(f"window {window_ms:.3f} ms; device busy {busy_ms:.3f} ms "
        f"(idle share {rec['idle_share']}); {device_ms:.3f} ms over "
        f"{len(intervals)} device events, {n_kernels} kernels")
    out(f"{'kernel':<60}{'total ms':>12}{'count':>8}{'share':>8}")
    for name, ms, count in rec["by_name"]:
        share = 100.0 * ms / device_ms if device_ms else 0.0
        out(f"{name[:59]:<60}{ms:>12.4f}{count:>8}{share:>7.1f}%")
    out(f"{'device idle, by innermost program span':<60}{'idle ms':>12}")
    for name, ms in rec["idle_by_span"]:
        out(f"{name[:59]:<60}{ms:>12.4f}")
    return rec


def profile_prove(prove_once, trace_path: str, device) -> float:
    """prove_once() inside torch.profiler (CPU and CUDA activities), in
    the range ``qzk_prove``; exports the chrome trace to trace_path and
    returns the prove's seconds on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            prove_once()
            sync()
        seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    return seconds


def _prover(circuit: str, device):
    """(prove_once, verify) of the profiled circuit; each prove is given
    a host-clock timer, so that the program records its spans."""
    from ..plonk.prover import PhaseTimer

    if circuit == "wormhole":
        from ..models.wormhole.circuit import WormholeCircuit
        from ..models.wormhole.fixtures import synthetic_circuit_inputs
        from ..models.wormhole.prover import WormholeProver
        from ..plonk.config import CircuitConfig

        cfg = CircuitConfig.standard_recursion_zk_config()
        circuit_obj = WormholeCircuit(cfg)
        targets = circuit_obj.targets()
        data = circuit_obj.build_circuit()
        inputs = synthetic_circuit_inputs()

        def prove_once():
            prover = WormholeProver(cfg, _circuit_data=data.prover_data(),
                                    _targets=targets, device=device)
            return prover.commit(inputs).prove(timer=PhaseTimer())

        return prove_once, data.verify
    from ..plonk.builder import CircuitBuilder
    from ..plonk.config import CircuitConfig
    from ..plonk.witness import PartialWitness

    builder = CircuitBuilder(CircuitConfig.standard_recursion_zk_config())
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    data = builder.build()

    def prove_small():
        pw = PartialWitness()
        pw.set_target(x, 7)
        return data.prove(pw, device=device, timer=PhaseTimer())

    return prove_small, data.verify


def card_name(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--outdir", default=os.path.join("chiprun_out", "profile"))
    ap.add_argument("--circuit", choices=("wormhole", "small"), default="wormhole")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    prove_once, verify = _prover(args.circuit, device)
    t0 = time.perf_counter()
    verify(prove_once())
    print(f"warm-up prove and verify: {time.perf_counter() - t0:.3f} s", flush=True)
    trace = os.path.join(args.outdir, "prove_fused.json")
    seconds = profile_prove(prove_once, trace, device)
    print(f"profiled prove: {seconds:.4f} s on the host clock; trace {trace}")
    rec = summarize(trace, top=args.top)
    rec.update(circuit=args.circuit, prove_s=seconds, device=device.type,
               card=card_name(device), torch=torch.__version__)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
