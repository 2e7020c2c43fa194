"""Sharded-NTT benchmark: the distributed four-step NTT
(parallel/ntt_sharded.py) of one 2^N Goldilocks vector over a mesh of
shards.  Counterpart of the JAX package's benches/bench_ntt_sharded.py.

    python3 -m qzk_tpu_torch.benches.ntt_sharded [--log-n 22] [--shards 4] [--device cpu]

On the card the mesh is `--shards` shards round-robin over the visible
cards (four shards on one card share it); with --device cpu, that many
"cpu" shards.  The input is sharded once; each timed call is one
ntt_sharded over the device-resident blocks, between two synchronizes
of every card of the mesh, on the host clock (best of 5 after a
warm-up).  Before timing, the gathered result must equal the
single-device four-step NTT (K3 on the card, its plain version on the
CPU) bit for bit.  Prints one JSON line, goldilocks_ntt_2pow{N}_sharded,
with the single-device time beside it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _sync(devices) -> None:
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def best_s(fn, devices, reps: int = 5) -> float:
    """The least host-clock time of one fn() call, in seconds, after one
    warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        _sync(devices)
        t0 = time.perf_counter()
        fn()
        _sync(devices)
        best = min(best, time.perf_counter() - t0)
    return best


def run(log_n: int, shards: int, device: torch.device, emit=print) -> dict:
    from ..ops import goldilocks as gl
    from ..ops import goldilocks_torch as gt
    from ..ops import ntt_fourstep as nfs
    from ..parallel import sharded
    from ..parallel.ntt_sharded import ntt_sharded
    from .kernels import card

    on_card = device.type == "cuda"
    mesh = sharded.make_mesh(shards) if on_card else sharded.make_mesh(shards, devices=[device])
    rng = np.random.default_rng(0)
    x = rng.integers(0, gl.P, size=(1, 1 << log_n), dtype=np.uint64)
    blocks = sharded.shard(x, mesh, axis=-1)
    single_in = gt.from_u64(x, mesh.devices[0])
    plan = nfs.get_fourstep_cuda_plan(log_n)
    want = plan.ntt(single_in)
    got = sharded.gather(ntt_sharded(blocks, mesh), axis=-1)
    if not torch.equal(got, want):
        raise AssertionError("sharded NTT != single-device four-step NTT")
    record = {
        "metric": f"goldilocks_ntt_2pow{log_n}_sharded",
        "value": best_s(lambda: ntt_sharded(blocks, mesh), mesh.devices),
        "unit": "s",
        "shards": mesh.size,
        "devices": sorted({str(d) for d in mesh.devices}),
        "single_device_s": best_s(lambda: plan.ntt(single_in), mesh.devices[:1]),
        "device": device.type,
        **(card() if on_card else {"card": "cpu", "power_limit": None}),
    }
    emit(json.dumps(record))
    return record


def main(argv=None) -> None:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--shards", type=int, default=4, help="mesh size (a power of two)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.log_n, args.shards, resolve_device(args.device),
        emit=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
