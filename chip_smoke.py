"""Drives the PyTorch/CUDA port (qzk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order:
  build    build the native (g++) and CUDA (nvcc) libraries, all at once;
  circuit  build the Wormhole circuit under the zk standard recursion
           config (the main path: the config of bench.py) and the non-zk
           one, and the voting circuit under both;
  kernels  hold each CUDA kernel (K1, K2: Poseidon; K3: NTT) against its
           plain torch version, bit for bit, at every shape the four
           proves give it (K1 also at the zk salted leaf widths), at the
           2^22 NTT's pass shapes and on edge inputs;
  ntt      the kernels benchmark's 2^22 forward NTT through K3, checked
           against the plain four-step NTT and the host oracle;
  prove    each circuit from its inputs through the staged device
           pipeline: a first prove, then a warm one with its phases
           timed by CUDA events and the kernel launches counted from 0
           (every kernel must be launched), its proof's sha256 held to
           the JAX package's; first the zk Wormhole, then one zk salt
           draw timed on its own and held to the CPU's draw, then the
           non-zk Wormhole and the voting proofs; then three more warm
           proves of each Wormhole config in turn, on the host clock;
  verify   verify every proof on the host; reject the zk Wormhole proof
           with a tampered public input and with a flipped salt word in
           a wires query opening, and the non-zk one with a tampered
           public input;
  report   one JSON line of kernel times and bounds (`ms`: CUDA events
           around 10 calls; K3 also `graph_ms`, over replays of a CUDA
           graph; K1 and K3 also at every shape the warm zk prove
           launched them with, summed as prove_ms, K3's from graph
           replays, and the same for the non-zk prove as *_nonzk), the
           card's name and power limit, and the final status line.

Every phase prints one line with its elapsed seconds before its result.
Any failure ends the run with a non-zero exit code and no status line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qzk_tpu_torch.benches.kernels import (  # noqa: E402
    INT_MULS_PER_PERM,
    bound_ms,
    ntt_axis0_work,
)
from qzk_tpu_torch.ops import goldilocks as gl  # noqa: E402
from qzk_tpu_torch.ops import goldilocks_torch as gt  # noqa: E402
from qzk_tpu_torch.ops import ntt as ntt_mod  # noqa: E402
from qzk_tpu_torch.ops import ntt_cuda as nc  # noqa: E402
from qzk_tpu_torch.ops import ntt_fourstep as nfs  # noqa: E402
from qzk_tpu_torch.ops import ntt_torch as ntp  # noqa: E402
from qzk_tpu_torch.ops import poseidon_cuda as pc  # noqa: E402
from qzk_tpu_torch.ops import poseidon_torch as pt  # noqa: E402
from qzk_tpu_torch.ops import threefry  # noqa: E402

# The kernels benchmark's NTT size: its 2^22 transform runs as two K3
# passes over (2048, 2048).
BENCH_LOG_N = 22

# A state whose permutation the kernels' weak rounds leave on p + 4 in
# lane 0 before the final canonical step: its last S-boxes give
# (ceil(p / 25), 0, ..., 0), which the last MDS layer takes to 25
# ceil(p / 25) = p + 4.  tests/test_torch_poseidon_fast.py derives it by
# running the permutation backwards.
NONCANONICAL_OUTPUT_STATE = np.array([
    0x095F8FA0D5AE5FC8, 0x7CDC47298510FF37, 0x3291DEEB307F63BD, 0x93239DF5EBA894F3,
    0x070762B8CEE9DB78, 0x6E8D6227553CFA0E, 0xC00D9F4CCD3C3E50, 0xB1D49A2243E9D80B,
    0x4564756F440902E5, 0x6061F0AF7450947B, 0xD13EF5028E11A8F9, 0x9FAA279CE55B21F6,
], dtype=np.uint64)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints '[phase] <name>: <seconds> s' when the block ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        log(f"[phase] {self.name}: {self.seconds:.3f} s")
        return False


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph and replayed, so that the host's launch rate does not set the
    time of a short kernel (K3 at the prover's shapes takes 10-30 us)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def edge_rows(rng, n: int, w: int, dev) -> torch.Tensor:
    """Random 64-bit lanes (canonical or not) with 0, 1, p-1, 2^63 and
    2^64-1 planted in every column."""
    x = rng.integers(0, 1 << 64, size=(n, w), dtype=np.uint64)
    edges = np.array([0, 1, gl.P - 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
    k = min(n, len(edges))
    x[:k, :] = edges[:k, None]
    x[-k:, :] = edges[:k, None][::-1]
    return gt.from_u64(x, dev)


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Bit-for-bit check (the tolerance is 0: integer field arithmetic).
    Returns the largest |got - want| over the uint64 values, and raises
    unless it is 0."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = gt.to_u64(got), gt.to_u64(want)
    err = int(np.max(np.maximum(g, w) - np.minimum(g, w), initial=0))
    if err:
        raise AssertionError(
            f"{name}: {int((g != w).sum())} of {g.size} words differ (max |err| {err})")
    return err


def phase_build(state) -> None:
    from qzk_tpu_torch import native

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    builds = {"native": native.get_lib, "poseidon": pc.library_path, "ntt": nc.library_path}
    with Phase("build"), ThreadPoolExecutor(len(builds)) as pool:
        done = {k: pool.submit(timed, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in done.items()}
    if done["native"][0] is None:
        raise RuntimeError("native host library did not build")
    log("build (in parallel): " + ", ".join(f"{k} {t:.2f} s" for k, (_, t) in done.items()))
    for key in ("poseidon", "ntt"):
        so = done[key][0]
        log(f"  {os.path.basename(so)}")
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Function properties" in line:
                    log("  ptxas: " + line.strip())


def kernel_widths(common) -> set[int]:
    """K1 widths of a circuit's prove: tree levels (8), the leaves of
    the preprocessed, wires, zs and quotient trees (the last three with
    four salt columns under zero knowledge), and the FRI layers."""
    cfg = common.config
    salt = 4 if cfg.zero_knowledge else 0
    pre_w = len(common.gates) + cfg.num_constants + cfg.num_routed_wires
    widths = {8, pre_w, cfg.num_wires + salt, common.num_zs_partial_products_polys + salt,
              common.num_quotient_polys + salt}
    for ab in cfg.fri_config.reduction_arity_bits(common.degree_bits):
        widths.add(2 << ab)
    return widths


def canonical_rows(rng, shape, dev) -> torch.Tensor:
    """Random canonical values with 0, 1 and p-1 planted."""
    x = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    x.reshape(-1)[:3] = [0, 1, gl.P - 1]
    x.reshape(-1)[-3:] = [gl.P - 1, 1, 0]
    return gt.from_u64(x, dev)


def ntt_shapes(common) -> set[tuple[int, int]]:
    """(log_n, batch) of every four-step NTT of a circuit's prove: the
    wires and zs iNTT at 2^degree_bits, the quotient iNTT at 2^lde_bits,
    and the LDE of the wires, zs, quotient and preprocessed rows."""
    cfg = common.config
    pre_w = len(common.gates) + cfg.num_constants + cfg.num_routed_wires
    zs = common.num_zs_partial_products_polys
    shapes = {(common.degree_bits, cfg.num_wires), (common.degree_bits, zs),
              (common.lde_bits, cfg.num_challenges)}
    for b in (cfg.num_wires, zs, common.num_quotient_polys, pre_w):
        shapes.add((common.lde_bits, b))
    return shapes


def check_k3(name: str, x: torch.Tensor, stw: torch.Tensor, tw) -> int:
    got = nc.ntt_axis0(x, stw, tw)
    torch.cuda.synchronize()
    return require_equal(name, got, ntp.ntt_axis0(x, stw, tw))


def phase_kernels(state) -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    lde = state["common"].lde_size
    results = []
    err = {"hash_rows": 0, "permute": 0, "ntt_axis0": 0}
    commons = [data.common for data, _ in state["circuits"].values()]
    widths = sorted(set().union(*map(kernel_widths, commons)))
    shapes = sorted(set().union(*map(ntt_shapes, commons)))
    with Phase("kernels"):
        for w in widths:
            for n in (lde, 1037):
                x = edge_rows(rng, n, w, dev)
                got = pc.hash_no_pad_rows(x)
                torch.cuda.synchronize()
                err["hash_rows"] = max(err["hash_rows"], require_equal(
                    f"K1 w={w} n={n}", got, pt.hash_no_pad_batch(x)))
                results.append(f"K1 w={w} n={n}")
        left, right = edge_rows(rng, 777, 4, dev), edge_rows(rng, 777, 4, dev)
        err["hash_rows"] = max(err["hash_rows"], require_equal(
            "K1 two_to_one", pc.two_to_one(left, right), pt.two_to_one_batch(left, right)))
        for b in (1 << 18, 999):
            s = edge_rows(rng, b, 12, dev)
            s[b // 2] = gt.from_u64(NONCANONICAL_OUTPUT_STATE, dev)
            got = pc.permute(s)
            torch.cuda.synchronize()
            err["permute"] = max(err["permute"], require_equal(f"K2 b={b}", got, pt.permute(s)))
            results.append(f"K2 b={b}")
        # K3: both passes of every main-path four-step transform, and of
        # the 2^22 one, as the plan launches them (the second reads the
        # transpose of the first's output in place)
        for log_n, b in shapes + [(BENCH_LOG_N, 1)]:
            plan = nfs.get_fourstep_cuda_plan(log_n)
            for inverse in (False, True):
                tw2, twiddle, tw1 = plan.tables(dev, inverse)
                x = canonical_rows(rng, (b, plan.n2, plan.n1), dev)
                a = nc.ntt_axis0(x, tw2, twiddle)
                err["ntt_axis0"] = max(err["ntt_axis0"], check_k3(
                    f"K3 2^{log_n} b={b} pass 1", x, tw2, twiddle))
                err["ntt_axis0"] = max(err["ntt_axis0"], check_k3(
                    f"K3 2^{log_n} b={b} pass 2", a.transpose(1, 2), tw1, None))
            results.append(f"K3 2^{log_n} b={b} (both passes, both directions)")
        # ragged column tiles, with and without the twiddle block, and
        # non-canonical 64-bit inputs; 2^13 and 2^14 rows (one column a
        # thread, the passes of the 2^26 to 2^28 transforms) also
        # transposed, as the second pass reads them
        for b, log_n, m in ((3, 8, 1000), (1, 11, 1037), (2, 13, 37), (1, 14, 19)):
            stw = gt.from_u64(ntp.stage_tw_table(log_n), dev)
            tw = canonical_rows(rng, (1 << log_n, m), dev)
            x = edge_rows(rng, b * (1 << log_n), m, dev).reshape(b, 1 << log_n, m)
            for t in (tw, None):
                err["ntt_axis0"] = max(err["ntt_axis0"], check_k3(
                    f"K3 ragged ({b}, {1 << log_n}, {m}) mul_tw={t is not None}", x, stw, t))
            if log_n > 11:
                xt = canonical_rows(rng, (b, m, 1 << log_n), dev).transpose(1, 2)
                err["ntt_axis0"] = max(err["ntt_axis0"], check_k3(
                    f"K3 transposed ({b}, {1 << log_n}, {m})", xt, stw, None))
            results.append(f"K3 ragged ({b}, {1 << log_n}, {m})")
    state["max_abs_err"] = err
    log(f"kernels: bit-exact against the plain torch versions: {', '.join(results)}")


def phase_ntt(state) -> None:
    """The kernels benchmark's 2^22 forward NTT through K3 against the
    plain four-step NTT on the card and the host oracle (native C++)."""
    dev = torch.device("cuda")
    n = 1 << BENCH_LOG_N
    x = np.random.default_rng(22).integers(0, gl.P, size=(1, n), dtype=np.uint64)
    x[0, :3] = [0, 1, gl.P - 1]
    coeffs = gt.from_u64(x, dev)
    plan = nfs.get_fourstep_cuda_plan(BENCH_LOG_N)
    with Phase("ntt"):
        got = plan.ntt(coeffs)
        torch.cuda.synchronize()
        require_equal("2^22 NTT, K3 vs plain four-step", got,
                      ntt_mod.get_fourstep_plan(BENCH_LOG_N).ntt(coeffs))
        require_equal("2^22 NTT, K3 vs ntt_np", got, gt.from_u64(ntt_mod.ntt_np(x), dev))
        require_equal("2^22 iNTT, K3", plan.intt(got), coeffs)
        ms = cuda_ms(lambda: plan.ntt(coeffs))
    log(f"ntt: 2^22 forward NTT through K3 equals the plain four-step NTT and ntt_np; "
        f"its inverse gives the input back; {ms:.4f} ms")


def k1_work(n: int, w: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one K1 call on (n, w): the rows
    read and the digests written once; one permutation a row for each
    8-word chunk."""
    return n * w * 8 + n * 4 * 8, n * max(1, -(-w // 8)) * INT_MULS_PER_PERM


def time_k1_per_prove(k1_shapes, rng, dev) -> tuple[float, list, float]:
    """K1's time summed over a warm prove's launches: each distinct
    (n, w) it was launched with, timed on edge inputs of that shape,
    times its count.  Returns the sum, [n, w, count, ms, bound_ms] per
    shape, and the summed bound."""
    shapes = []
    for (n, w), count in sorted(k1_shapes.items()):
        rows = edge_rows(rng, n, w, dev)
        ms = cuda_ms(lambda: pc.hash_no_pad_rows(rows))
        shapes.append([n, w, count, ms, bound_ms(*k1_work(n, w))[0]])
    return (sum(s[2] * s[3] for s in shapes), shapes, sum(s[2] * s[4] for s in shapes))


def time_k3_per_prove(k3_shapes, rng, dev) -> tuple[float, list, float]:
    """K3's time summed over a warm prove's launches, as for K1: each
    distinct (b, log_n, m, strided, twiddle) it was launched with, timed
    with graph_ms on canonical inputs of that shape and layout (a strided
    input is the transpose of a contiguous tensor, as the second
    four-step pass reads it), times its count.  Returns the sum, [b,
    log_n, m, strided, twiddle, count, ms, bound_ms] per shape, and the
    summed bound."""
    shapes = []
    for (b, log_n, m, strided, tw), count in sorted(k3_shapes.items()):
        n = 1 << log_n
        x = canonical_rows(rng, (b, m, n) if strided else (b, n, m), dev)
        x = x.transpose(1, 2) if strided else x
        stw = gt.from_u64(ntp.stage_tw_table(log_n), dev)
        twiddle = canonical_rows(rng, (n, m), dev) if tw else None
        ms = graph_ms(lambda: nc.ntt_axis0(x, stw, twiddle))
        bound, _ = bound_ms(*ntt_axis0_work(b, log_n, m, tw))
        shapes.append([b, log_n, m, strided, tw, count, ms, bound])
    return (sum(s[5] * s[6] for s in shapes), shapes, sum(s[5] * s[7] for s in shapes))


def time_kernels(state) -> list[dict]:
    """One record per kernel at the main path's largest shapes."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    common = state["common"]
    n, w = common.lde_size, common.config.num_wires
    rows = edge_rows(rng, n, w, dev)
    k1_ms = cuda_ms(lambda: pc.hash_no_pad_rows(rows))
    k1_plain = cuda_ms(lambda: pt.hash_no_pad_batch(rows), iters=2, warmup=1)
    k1_bytes, k1_ops = k1_work(n, w)
    # per warm prove: the zk main path's shapes, and the non-zk ones
    runs = {"": state["runs"]["wormhole_zk"], "_nonzk": state["runs"]["wormhole_nonzk"]}
    k1_prove = {tag: time_k1_per_prove(r["k1_shapes"], rng, dev) for tag, r in runs.items()}
    b = 1 << 18
    states = edge_rows(rng, b, 12, dev)
    k2_ms = cuda_ms(lambda: pc.permute(states))
    k2_plain = cuda_ms(lambda: pt.permute(states), iters=2, warmup=1)
    k2_bytes = 2 * states.numel() * 8
    k2_ops = b * INT_MULS_PER_PERM
    plan = nfs.get_fourstep_cuda_plan(BENCH_LOG_N)
    tw2, twiddle, _ = plan.tables(dev, False)
    x = canonical_rows(rng, (1, plan.n2, plan.n1), dev)
    k3_ms = cuda_ms(lambda: nc.ntt_axis0(x, tw2, twiddle))
    k3_graph_ms = graph_ms(lambda: nc.ntt_axis0(x, tw2, twiddle))
    k3_plain = cuda_ms(lambda: ntp.ntt_axis0(x, tw2, twiddle), iters=2, warmup=1)
    k3_bytes, k3_ops = ntt_axis0_work(1, plan.log2, plan.n1, True)
    k3_prove = {tag: time_k3_per_prove(r["k3_shapes"], rng, dev) for tag, r in runs.items()}
    launches = runs[""]["launches"]

    def rec(name, src, replaces, key, ms, plain, nbytes, ops, shape):
        bound, by = bound_ms(nbytes, ops)
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": state["max_abs_err"][key],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "shape": shape,
            "launches_by_path": {p: r["launches"][key] for p, r in state["runs"].items()},
        }

    def add_per_prove(record, per_prove):
        for tag, (total, shapes, bound) in per_prove.items():
            record.update({f"prove_ms{tag}": total, f"prove_shapes{tag}": shapes,
                           f"prove_bound_ms{tag}": bound})
            log(f"{record['name'].split()[0]} per warm {'non-zk' if tag else 'zk'} prove: "
                f"{len(shapes)} shapes, {sum(s[-3] for s in shapes)} launches, "
                f"{total:.4f} ms (bound {bound:.4f} ms)")

    k1 = rec("K1 hash_no_pad_rows", "qzk_tpu_torch/ops/csrc/poseidon.cu",
             "qzk_tpu/ops/poseidon_pallas.py:354", "hash_rows", k1_ms, k1_plain,
             k1_bytes, k1_ops, [n, w])
    add_per_prove(k1, k1_prove)
    k3 = rec("K3 ntt_axis0", "qzk_tpu_torch/ops/csrc/ntt.cu",
             "qzk_tpu/ops/ntt_pallas.py:119", "ntt_axis0", k3_ms, k3_plain,
             k3_bytes, k3_ops, [1, plan.n2, plan.n1])
    k3["graph_ms"] = k3_graph_ms
    add_per_prove(k3, k3_prove)
    return [
        k1,
        rec("K2 permute", "qzk_tpu_torch/ops/csrc/poseidon.cu",
            "qzk_tpu/ops/poseidon_pallas.py:275", "permute", k2_ms, k2_plain,
            k2_bytes, k2_ops, [b, 12]),
        k3,
    ]


# The circuits the run proves: the zk Wormhole is the main path.
PATHS = ("wormhole_zk", "wormhole_nonzk", "voting_nonzk", "voting_zk")
KERNELS = ("hash_rows", "permute", "ntt_axis0")


def phase_circuit(state) -> None:
    from qzk_tpu_torch.models.voting.fixtures import build_vote_circuit
    from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit
    from qzk_tpu_torch.plonk.config import CircuitConfig

    configs = {"zk": CircuitConfig.standard_recursion_zk_config(),
               "nonzk": CircuitConfig.standard_recursion_config()}
    circuits = {}
    with Phase("circuit"):
        for name in PATHS:
            model, tag = name.split("_")
            if model == "wormhole":
                circuit = WormholeCircuit(configs[tag])
                targets = circuit.targets()
                circuits[name] = (circuit.build_circuit(), targets)
            else:
                circuits[name] = build_vote_circuit(configs[tag])
    state.update(circuits=circuits, common=circuits["wormhole_zk"][0].common)
    for name, (data, _) in circuits.items():
        log(f"circuit {name}: degree 2^{data.common.degree_bits}, "
            f"{len(data.common.gates)} gate types, zk {data.common.config.zero_knowledge}")


def prover_of(state, name):
    """prove(timer=None) -> a fresh proof of circuit `name` from its
    inputs, on the card."""
    from qzk_tpu_torch.models.voting.fixtures import create_test_inputs
    from qzk_tpu_torch.models.wormhole.fixtures import synthetic_circuit_inputs
    from qzk_tpu_torch.models.wormhole.prover import WormholeProver
    from qzk_tpu_torch.plonk.witness import PartialWitness

    data, targets = state["circuits"][name]
    if name.startswith("wormhole"):
        def prove(timer=None):
            prover = WormholeProver(data.common.config, _circuit_data=data.prover_data(),
                                    _targets=targets, device="cuda")
            return prover.commit(synthetic_circuit_inputs()).prove(timer=timer)
    else:
        def prove(timer=None):
            pw = PartialWitness()
            create_test_inputs().fill_targets(pw, targets)
            return data.prove(pw, device="cuda", timer=timer)
    return prove


def drive(state, name) -> None:
    """Prove circuit `name` once, then once warm with its phases timed
    and the kernel launches counted from 0; every kernel must have been
    launched and the proof's sha256 must be the JAX package's."""
    from qzk_tpu_torch.models.voting import fixtures as vfix
    from qzk_tpu_torch.models.wormhole import fixtures as wfix
    from qzk_tpu_torch.plonk.prover import PhaseTimer

    pins = {"wormhole_zk": wfix.WORMHOLE_ZK_PROOF_SHA256,
            "wormhole_nonzk": wfix.WORMHOLE_NONZK_PROOF_SHA256,
            "voting_nonzk": vfix.VOTING_NONZK_PROOF_SHA256,
            "voting_zk": vfix.VOTING_ZK_PROOF_SHA256}
    prove = prover_of(state, name)
    with Phase(f"prove {name} (first, includes per-circuit device setup)"):
        prove()
    timer = PhaseTimer(cuda_events=True)
    pc.reset_launches()
    nc.reset_launches()
    with Phase(f"prove {name} (warm)") as ph:
        proof = prove(timer)
    launches = {**pc.LAUNCHES, **nc.LAUNCHES}
    state["runs"][name] = {
        "proof": proof, "prove": prove, "launches": launches,
        "k1_shapes": Counter(pc.K1_SHAPES), "k3_shapes": Counter(nc.K3_SHAPES),
    }
    for phase, ms in timer.results():
        log(f"  prove {name} phase {phase}: {ms / 1e3:.4f} s")
    log(f"prove {name}: {ph.seconds:.3f} s; launches K1 {launches['hash_rows']}, "
        f"K2 {launches['permute']}, K3 {launches['ntt_axis0']}")
    for key in KERNELS:
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} was not launched on the {name} path")
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    if digest != pins[name]:
        raise AssertionError(f"{name} proof sha256 {digest} != {pins[name]}")
    log(f"prove {name}: proof sha256 {digest} matches the JAX package's")


def time_salt_draw(state) -> None:
    """One zk salt draw, (lde_size, 4), on the card: equal to the CPU's
    draw, and its time by CUDA events around 10 draws."""
    dev = torch.device("cuda")
    _, sub = threefry.split(threefry.prng_key(20261017))
    shape = (state["common"].lde_size, 4)
    got = threefry.random_bits_u64_shr1(sub, shape, dev)
    require_equal(f"salt draw {shape}", got, threefry.random_bits_u64_shr1(sub, shape, "cpu"))
    ms = cuda_ms(lambda: threefry.random_bits_u64_shr1(sub, shape, dev))
    log(f"salt draw {shape}: {ms:.4f} ms (CUDA events, 10 draws), equal to the CPU's "
        f"draw; three a zk prove")


def phase_prove(state) -> None:
    state["runs"] = {}
    drive(state, "wormhole_zk")
    time_salt_draw(state)
    for name in PATHS[1:]:
        drive(state, name)
    spread = {"wormhole_zk": [], "wormhole_nonzk": []}
    with Phase("prove spread (warm, host clock, zk and non-zk in turn)"):
        for _ in range(3):
            for name, times in spread.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state["runs"][name]["prove"]()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
    for name, times in spread.items():
        log(f"prove spread {name}: " + ", ".join(f"{t:.4f}" for t in times) + " s")


def rejects(verify, proof) -> bool:
    from qzk_tpu_torch.plonk.fri import VerificationError

    try:
        verify(proof)
    except VerificationError:
        return True
    return False


def verifier_of(state, name):
    """verify(proof) of circuit `name`, through its session API."""
    from qzk_tpu_torch.models.wormhole.verifier import WormholeVerifier

    data = state["circuits"][name][0]
    if name.startswith("wormhole"):
        return WormholeVerifier.new(data.common.config, data.verifier_data()).verify
    return data.verifier_data().verify


def phase_verify(state) -> None:
    import copy

    with Phase("verify"):
        for name, run in state["runs"].items():
            verifier_of(state, name)(run["proof"])
        zk_verify = verifier_of(state, "wormhole_zk")
        zk_proof = state["runs"]["wormhole_zk"]["proof"]
        bad_pi = copy.deepcopy(zk_proof)
        bad_pi.public_inputs[0] = np.uint64((int(bad_pi.public_inputs[0]) + 1) % gl.P)
        bad_salt = copy.deepcopy(zk_proof)
        leaf = bad_salt.proof.fri.query_rounds[0].initial.leaves[1]
        if len(leaf) != state["common"].config.num_wires + 4:
            raise AssertionError(f"wires leaf of {len(leaf)} words carries no salt")
        leaf[-1] = np.uint64((int(leaf[-1]) + 1) % gl.P)
        nonzk = state["runs"]["wormhole_nonzk"]["proof"]
        bad_nonzk = copy.deepcopy(nonzk)
        bad_nonzk.public_inputs[0] = np.uint64((int(bad_nonzk.public_inputs[0]) + 1) % gl.P)
        checks = {
            "zk tampered public input": rejects(zk_verify, bad_pi),
            "zk flipped salt word": rejects(zk_verify, bad_salt),
            "non-zk tampered public input": rejects(
                verifier_of(state, "wormhole_nonzk"), bad_nonzk),
        }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"the verifier accepted a proof with a {what}")
    log(f"verify: {', '.join(state['runs'])} proofs verify; rejected: {', '.join(checks)}")


def phase_report(state) -> None:
    with Phase("report"):
        kernels = time_kernels(state)
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    state: dict = {}
    t0 = time.perf_counter()
    for phase in (phase_build, phase_circuit, phase_kernels, phase_ntt, phase_prove,
                  phase_verify, phase_report):
        phase(state)
    log(f"[phase] total: {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
