"""The benchmark of qzk_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the cells are BENCHMARK.json's
`workloads`.  Set-up (circuits, the seeded traffic, warm-up) comes first,
then `--seconds` of closed-loop requests; then the device's peak memory
is read, the program's state freed, and every answer checked by the plain
reference in benchmark/reference/ (which imports nothing of the program).
The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones, read in a torch.profiler window), device, breakdown
(--trace 1) and checks, each compared number beside its limit; the same
numbers end standard error.  An earlier line names the card and its power
limit.  Without a CUDA card, or with fewer cards than the cell asks for,
the run exits with 3 and prints no result; if JAX or the JAX package was
loaded, with 4; if one of the cell's metrics read nothing (a per-layer
reader finds no kernel, phase or count of the program that it reads by
name), with 5.

Caches, at fixed paths inside the checkout (benchmark/.gitignore lists
them): benchmark/.cache/circuits/ (the Wormhole circuit's artifacts and,
through QZK_CIRCUIT_CACHE_DIR, the program's chunk-circuit blobs, about
0.5 GB each; a checkout's first run of a cell writes them, later runs
load them) and benchmark/.cache/trace/ (the traced window's chrome
trace, deleted once read).  The program's own CUDA build goes to
build/qzk_tpu_torch/ in the checkout.

What a later change adds as files, with its entries in BENCHMARK.json:
- a configuration: benchmark/configs/<name>.json (its sizes, the keys the
  reference holds the program's to, and `runner`, the name of
  benchmark/runners/<runner>.py, which sets up the program, sends one
  request and checks the answers);
- a traffic mix: benchmark/traffic/<name>.json, parameters that
  harness/traffic.py reads (callers, pool sizes, the storage-proof
  template, the traced window's lead and length);
- a metric: benchmark/metrics/<name>.py with read(run) -> number or None
  (run: harness/cell.py's Run); a metric named <kind>.<part> whose file
  is missing reads with benchmark/metrics/<kind>.py, so a cell's own
  instance of a kind of reading needs only its entry.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
NO_CARD, JAX_LOADED, UNREAD = 3, 4, 5


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi: not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.getcwd()
    sys.path[:0] = [BENCH_DIR, root]
    from harness import spec

    cell = spec.load_cell(root, args.workload)
    cache = os.path.join(BENCH_DIR, ".cache")
    os.environ["QZK_CIRCUIT_CACHE_DIR"] = os.path.join(cache, "circuits")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(map(str, range(cell.chips))))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return NO_CARD
    print(f"card: {card_line()}", flush=True)

    from harness import cell as cell_mod

    result, lines, unread = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                              PROCESS_START, cache)
    found = cell_mod.forbidden_modules()
    if found:
        print(f"modules the port must not load were loaded: {found}", file=sys.stderr)
        return JAX_LOADED
    for line in lines:
        print(line, file=sys.stderr)
    if unread:
        print(f"metrics that read nothing: {unread}; each reader's docstring names what "
              "of the program it reads", file=sys.stderr)
        return UNREAD
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
