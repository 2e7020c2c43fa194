"""Kernel microbenchmarks of the port on one NVIDIA GPU: Poseidon
permutations per second and the 2^22 Goldilocks NTT time, the
north-star kernel metrics of BASELINE.json, each beside the card's
roofline.  Counterpart of the JAX package's benches/bench_kernels.py.

    python3 -m qzk_tpu_torch.benches.kernels [--log-n 22] [--poseidon-batch 20] [--device cpu]

Prints one JSON line per metric, under the JAX bench's names with
``_cuda`` in place of ``_pallas``:
  poseidon_permutations_per_s_{torch,cuda}, poseidon_permutations_per_s;
  goldilocks_ntt_2pow{N}_{radix2,fourstep_torch,fourstep_cuda},
  goldilocks_ntt_2pow{N}.
Times are medians of CUDA-event spans, one call each, after a warm-up.
Before timing, the K3 four-step output must equal the plain four-step
output bit for bit, and a kernel that fails ends the run.  With
``--device cpu`` the plain torch variants run on the CPU and the
``_cuda`` lines are left out (the kernels exist only on the card).

Roofline of one H100 SXM at 700 W: device-memory bytes at PEAK_BYTES
(NVIDIA's data sheet), and 32-bit integer multiplies at the card's
throughput for them, peak_int_muls().
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

PEAK_BYTES = 3.35e12

# 32-bit integer multiplies and multiply-adds run at 64 a clock on each SM
# of compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput).  Without a card, the H100 SXM's 132 SMs at its
# 1.98 GHz boost clock (NVIDIA's data sheet) stand in.
INT_MULS_PER_CLOCK_PER_SM = 64
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9

# 32-bit integer multiplies: a 64x64-bit product is four 32x32 partial
# products, and its reduction one more.  One Poseidon permutation: 8
# full rounds of 12 S-boxes and 22 partial rounds of 1 S-box, at 4
# products an S-box; 30 MDS layers of 144 small products on each of
# the two 32-bit halves, plus one reduction per lane.
INT_MULS_PER_MULMOD = 5
MULMODS_PER_PERM = 4 * (8 * 12 + 22)
INT_MULS_PER_PERM = INT_MULS_PER_MULMOD * MULMODS_PER_PERM + 30 * (144 * 2 + 12)


def peak_int_muls() -> float:
    """32-bit integer multiplies a second: 64 a clock on each SM, times
    the SM count and clock of card 0 from torch.cuda.get_device_properties
    where it reports them, else those of the H100 SXM."""
    sms, clock_hz = H100_SMS, H100_CLOCK_HZ
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        sms = props.multi_processor_count or sms
        clock_hz = getattr(props, "clock_rate", 0) * 1e3 or clock_hz  # kHz
    return INT_MULS_PER_CLOCK_PER_SM * sms * clock_hz


def bound_ms(nbytes: float, int_muls: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = int_muls / peak_int_muls() * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ntt_axis0_work(b: int, log_n: int, m: int, mul_tw: bool) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one K3 call on (b, 2^log_n, m):
    input and output once, the twiddle block and stage table once; one
    modular product a butterfly, and one an element with the twiddle."""
    n = 1 << log_n
    elems = b * n * m
    nbytes = 8 * (2 * elems + (n * m if mul_tw else 0) + log_n * max(1, n // 2))
    mulmods = b * m * (n // 2) * log_n + (elems if mul_tw else 0)
    return nbytes, INT_MULS_PER_MULMOD * mulmods


def card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(",", 1))
    return {"card": name, "power_limit": limit}


def median_ms(fn, device: torch.device, iters: int = 11, warmup: int = 2) -> float:
    """Median time of one fn() call in ms: CUDA events on the card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(log_n: int, poseidon_batch: int, device: torch.device, emit=print) -> None:
    from ..ops import goldilocks as gl
    from ..ops import goldilocks_torch as gt
    from ..ops import ntt as ntt_mod
    from ..ops import ntt_fourstep as nfs
    from ..ops import poseidon_cuda as pc
    from ..ops import poseidon_torch as pt

    on_card = device.type == "cuda"
    where = card() if on_card else {"card": "cpu", "power_limit": None}

    def line(**kw):
        emit(json.dumps({**kw, "device": str(device), **where}))

    rng = np.random.default_rng(0)

    # --- Poseidon permutation throughput ---------------------------------
    b = 1 << poseidon_batch
    states = gt.from_u64(rng.integers(0, gl.P, size=(b, 12), dtype=np.uint64), device)
    perm_bound, _ = bound_ms(2 * states.numel() * 8, b * INT_MULS_PER_PERM)
    roof_rate = b / (perm_bound / 1e3)
    roof = {"roofline_perm_per_s": roof_rate,
            "roofline_model": "max(2*96 B a state / 3.35e12 B/s, "
                              f"{INT_MULS_PER_PERM} 32-bit muls a permutation / "
                              f"{peak_int_muls():.4g} /s)"}
    if not torch.equal(pc.permute(states), pt.permute(states)):
        raise AssertionError("K2 permutation != its plain torch version")
    variants = [("torch", pt.permute)] + ([("cuda", pc.permute)] if on_card else [])
    best = None
    for name, fn in variants:
        rate = b / (median_ms(lambda: fn(states), device) / 1e3)
        line(metric=f"poseidon_permutations_per_s_{name}", value=rate, unit="perm/s",
             batch=b, **roof)
        if best is None or rate > best[1]:
            best = (name, rate)
    line(metric="poseidon_permutations_per_s", value=best[1], unit="perm/s", batch=b,
         kernel=best[0], efficiency_pct=100 * best[1] / roof_rate if on_card else None,
         **roof)

    # --- 2^log_n Goldilocks NTT -------------------------------------------
    n = 1 << log_n
    coeffs = gt.from_u64(rng.integers(0, gl.P, size=(1, n), dtype=np.uint64), device)
    ntt_bound, ntt_by = bound_ms(2 * n * 8, INT_MULS_PER_MULMOD * (n // 2) * log_n)
    radix2 = ntt_mod.get_plan(log_n)
    fourstep = ntt_mod.get_fourstep_plan(log_n)
    k3 = nfs.get_fourstep_cuda_plan(log_n)
    roof = {"roofline_s": ntt_bound / 1e3, "roofline_by": ntt_by,
            "roofline_model": "max(2*8n B / 3.35e12 B/s, "
                              "n/2*log2(n) modular products * 5 32-bit muls / "
                              f"{peak_int_muls():.4g} /s)"}
    want = fourstep.ntt(coeffs)
    if not torch.equal(radix2.ntt(coeffs), want):
        raise AssertionError("radix-2 NTT != plain four-step NTT")
    if not torch.equal(k3.ntt(coeffs), want):
        raise AssertionError("K3 four-step NTT != plain four-step NTT")
    variants = [("radix2", radix2.ntt), ("fourstep_torch", fourstep.ntt)]
    if on_card:
        variants.append(("fourstep_cuda", k3.ntt))
    best = None
    for name, fn in variants:
        s = median_ms(lambda: fn(coeffs), device) / 1e3
        line(metric=f"goldilocks_ntt_2pow{log_n}_{name}", value=s, unit="s", **roof)
        if best is None or s < best[1]:
            best = (name, s)
    line(metric=f"goldilocks_ntt_2pow{log_n}", value=best[1], unit="s", kernel=best[0],
         efficiency_pct=100 * roof["roofline_s"] / best[1] if on_card else None, **roof)


def main(argv=None) -> None:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--poseidon-batch", type=int, default=20,
                    help="log2 of the number of width-12 permutations per call")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.log_n, args.poseidon_batch, resolve_device(args.device),
        emit=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
