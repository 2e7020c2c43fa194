"""Drives the PyTorch/CUDA port (qzk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --multicard   (two cards or more: only the
                                         sharded phase's multi-card checks)

Phases, in order:
  build    build the native (g++) and CUDA (nvcc) libraries, all at once
           (poseidon.cu, ntt.cu and field.cu, one nvcc each);
  circuit  build the Wormhole circuit under the zk standard recursion
           config (the main path: the config of bench.py) and the non-zk
           one, the voting circuit under both, and the aggregator's
           chunk circuits: branching 1 over the square test circuit, and
           branching 2 over the zk Wormhole (the (2, 1) tree's);
  kernels  hold each CUDA kernel (K1, K2: Poseidon; K3: NTT) against its
           plain torch version, bit for bit, at every shape the four
           proves and the two chunk proves give it (K1 also at the zk
           salted leaf widths), at the 2^22 NTT's pass shapes and on
           edge inputs;
  ntt      the kernels benchmark's 2^22 forward NTT through K3, checked
           against the plain four-step NTT and the host oracle;
  prove    each circuit from its inputs through the fused device
           pipeline (the default path: one CUDA graph a circuit and
           config, captured at the first prove): a first prove, with its
           graph's warm-up and capture seconds and the device memory the
           capture reserved, then a warm one with its phases timed by
           CUDA events and the kernel launches counted from 0 (every
           kernel must be launched, and the prove must be one graph
           replay), its proof's sha256 held to the JAX package's; first
           the zk Wormhole, with the host synchronisations of one more
           warm prove counted, then one zk salt draw timed on its own and
           held to the CPU's draw, then the non-zk Wormhole and the
           voting proofs; then three more warm proves of each Wormhole
           config in turn, on the host clock;
  kernels (field)  hold each field op of K4-K7 (field.cu: the field map
           and the Poseidon gate's round, inverses, powers, sums, weighted
           sums and chunk products) against its plain torch version
           (goldilocks_torch, poseidon_torch for the round), bit for bit,
           at every (op, shape, strides) that the warm proves of the
           prove phase launched it with (goldilocks_cuda.FIELD_SHAPES),
           and pow7 at the round's (12, LDE) shape, on inputs with 0, 1,
           p-1, 2^63 and 2^64-1 planted; the sharded phase does the same
           for the keys that only the chunk and sharded proves launched;
  aggregate  the recursion layer on the card: the square chunk proof,
           first and warm, its sha256 held to the JAX package's; a
           second zk Wormhole leaf (exit account 0x05..., the first is
           the zk Wormhole proof above); then aggregate_to_tree over the
           two as a (2, 1) tree, cold and then warm with its phases
           timed by CUDA events and the kernel launches counted from 0
           (every kernel must be launched, the warm prove one graph
           replay), its root's sha256 held to the JAX package's, and the
           peak device memory of each; then one zk salt draw at the chunk
           prove's shape, timed and held to the CPU's draw;
  sharded  the sharded prover (qzk_tpu_torch/parallel/) on one card: the
           zk Wormhole over a mesh of 4 shards on cuda:0 and the non-zk
           one over 8, each first and then warm with its phases timed by
           CUDA events, the kernel launches counted from 0 (K1-K7 must
           each be launched), the peak device memory, the
           precondition fallback's warning raised as an error and
           sharded_prove's own count checked, its proof held to the
           single-device pin; the 2^22 NTT through ntt_sharded over 4
           shards against the single-device K3 result; K1, K3 and K4-K7
           against their plain versions at every shape the two warm
           proves gave them; with two cards or more, the zk proof on a
           mesh of one shard a card at the same pin, and a (2, 2) tree whose chunks
           fan out across the cards, its root equal to one worker's on
           one card (with one card, a line says why they did not run);
  artifacts  the resume paths: write the non-zk Wormhole's common.bin,
           verifier.bin and prover.bin (generate_circuit_binaries), hold
           the first two to their sha256 pins, and time reading and
           writing prover.bin; prove from the files
           (WormholeProver.new_from_files) on the card, with the kernel
           launches counted from 0, the proof held to the non-zk pin and
           verified by WormholeVerifier.new_from_files; write the proved
           (2, 1) chunk circuit through the disk cache into a fresh
           directory, reload it through build_chunk_circuit with no host
           build, check that the reload carries no prover context, and
           aggregate the two leaves with it, with the kernel launches
           counted from 0 and the root held to its pin; write the zk
           Wormhole proof in the qp-plonky2 byte format, hold it to its
           pin, and read it back; run the port's dummy-proof tool
           (tools/export_dummy_proof.py) into a temporary directory and
           hold its two files to the zk and non-zk Wormhole pins;
  verify   verify every proof on the host; reject the zk Wormhole proof
           with a tampered public input and with a flipped salt word in
           a wires query opening, and the non-zk one with a tampered
           public input; verify the square chunk proof and the (2, 1)
           root, parse the two leaves' public inputs back from the root,
           and reject the root with a tampered public input;
  report   the device memory the graphs hold; one JSON line of kernel
           times and bounds (`ms`: CUDA events around 10 calls; K3 also
           `graph_ms`, over replays of a CUDA graph; K1 and K3 also at
           every shape the warm zk prove launched them with, summed as
           prove_ms, K3's from graph replays, and the same for the
           non-zk prove as *_nonzk and for the warm (2, 1) chunk prove
           as *_agg, for the warm sharded proves as *_sharded4 (zk,
           4 shards) and *_sharded8 (non-zk, 8 shards); K2 also at
           (1, 12), the device challenger's duplex,
           beside that shape's dependent-chain bound, and summed over
           the warm zk prove's launches; K4-K7 at each family's costliest
           key of the warm zk prove among the keys of its redesigned ops
           (pow7, the round, dot_mod, prod_chunks; batch_divide_axis,
           timed also at 16, 32 and 64 threads a lane, with
           ext_inverse_vec's costliest key beside it; the multi-base
           powers), and summed over its launches, in all and by op, each
           key's row in a `field_shapes` JSON line; K5 and K6 also at the
           keys of the warm (2, 1) chunk prove, `field_shapes_agg`),
           the card's name and power limit, and the final status line.

Every phase prints one line with its elapsed seconds before its result.
Any failure ends the run with a non-zero exit code and no status line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qzk_tpu_torch.benches.kernels import (  # noqa: E402
    INT_MULS_PER_CLOCK_PER_SM,
    INT_MULS_PER_MULMOD,
    INT_MULS_PER_PERM,
    bound_ms,
    ntt_axis0_work,
    peak_int_muls,
)
from qzk_tpu_torch.ops import goldilocks as gl  # noqa: E402
from qzk_tpu_torch.ops import goldilocks_cuda as gc  # noqa: E402
from qzk_tpu_torch.ops import goldilocks_torch as gt  # noqa: E402
from qzk_tpu_torch.ops import ntt as ntt_mod  # noqa: E402
from qzk_tpu_torch.ops import ntt_cuda as nc  # noqa: E402
from qzk_tpu_torch.ops import ntt_fourstep as nfs  # noqa: E402
from qzk_tpu_torch.ops import ntt_torch as ntp  # noqa: E402
from qzk_tpu_torch.ops import poseidon_cuda as pc  # noqa: E402
from qzk_tpu_torch.ops import poseidon_torch as pt  # noqa: E402
from qzk_tpu_torch.ops import threefry  # noqa: E402
from qzk_tpu_torch.ops import threefry_cuda as tc  # noqa: E402
from qzk_tpu_torch.utils import spans  # noqa: E402

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
    with pc.recording(), nc.recording(), gc.recording(), torch.cuda.graph(graph):
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

    builds = {"native": native.get_lib, "poseidon": pc.library_path, "ntt": nc.library_path,
              "field": gc.library_path, "threefry": tc.library_path}
    with Phase("build"), ThreadPoolExecutor(len(builds)) as pool:
        done = {k: pool.submit(timed, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in done.items()}
    if done["native"][0] is None:
        raise RuntimeError("native host library did not build")
    log("build (in parallel): " + ", ".join(f"{k} {t:.2f} s" for k, (_, t) in done.items()))
    for key in ("poseidon", "ntt", "field", "threefry"):
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
    chunk_commons = [state["square"][0].common] + [c.data.common for c in state["chunks"].values()]
    # K1 at the main path's LDE rows for the four circuits' widths, and at
    # each chunk circuit's own LDE rows (2^16, 2^18) for its widths (and
    # the square child's, 2^5)
    k1_checks = {(w, n) for w in set().union(*map(kernel_widths, commons))
                 for n in (lde, 1037)}
    for c in chunk_commons:
        k1_checks |= {(w, n) for w in kernel_widths(c) for n in (c.lde_size, 1037)}
    shapes = sorted(set().union(*map(ntt_shapes, commons + chunk_commons)))
    with Phase("kernels"):
        for w, n in sorted(k1_checks):
            x = edge_rows(rng, n, w, dev)
            got = pc.hash_no_pad_rows(x)
            torch.cuda.synchronize()
            err["hash_rows"] = max(err["hash_rows"], require_equal(
                f"K1 w={w} n={n}", got, pt.hash_no_pad_batch(x)))
            results.append(f"K1 w={w} n={n}")
        left, right = edge_rows(rng, 777, 4, dev), edge_rows(rng, 777, 4, dev)
        err["hash_rows"] = max(err["hash_rows"], require_equal(
            "K1 two_to_one", pc.two_to_one(left, right), pt.two_to_one_batch(left, right)))
        # the PoW batch, a ragged batch, and the device challenger's duplex
        for b in (1 << 18, 999, 1):
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


# The field kernels (K4-K7, csrc/field.cu): each family's record name
# and JAX counterpart (XLA code of goldilocks_jax and of the Poseidon
# gate's round; no Pallas kernel).
FIELD_RECORDS = {
    "field_map": ("K4 field_map", "qzk_tpu/ops/goldilocks_jax.py:47-113, :238-248; "
                                  "qzk_tpu/plonk/gates.py:489-500"),
    "field_inverse": ("K5 field_inverse",
                      "qzk_tpu/ops/goldilocks_jax.py:129-150, :166-190, :250-256"),
    "field_powers": ("K6 field_powers", "qzk_tpu/ops/goldilocks_jax.py:153-163, :258-268"),
    "field_reduce": ("K7 field_reduce", "qzk_tpu/ops/goldilocks_jax.py:192-227; "
                                        "qzk_tpu/plonk/vanishing.py:140-161"),
}
# The ops of each family's redesign: a family's record takes the
# costliest of these keys.
REDESIGNED_OPS = ("pow7", "mds_full", "mds_partial", "dot_mod", "prod_chunks",
                  "batch_divide_axis", "powers_vec_multi", "ext_powers_multi")
# A key recorded beside its family's: the element-wise extension inverse
# of the FRI input (the addition chain's other user).
BESIDE_OPS = {"field_inverse": "ext_inverse_vec"}
# The families whose keys of the warm (2, 1) chunk prove the report
# times too (its 2^15 lanes and powers)
AGG_FAMILIES = ("field_inverse", "field_powers")
# log2 of the threads a lane that the report times batch_divide_axis at,
# beside the kernel's default
BATCH_GROUP_SWEEP = (4, 5, 6)
FIELD_EDGES = np.array([0, 1, gl.P - 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)


def key_words(key) -> int:
    """The words a FIELD_SHAPES key's largest operand spans."""
    _, shape, strides, _ = key
    return max(1 + sum((n - 1) * s for n, s in zip(shape, st)) for st in strides)


class FieldPool:
    """Random 64-bit words on the card, with 0, 1, p-1, 2^63 and 2^64-1
    planted at one word in 64; make(n) is n of them from a random start,
    so that the operands of one call differ."""

    def __init__(self, rng, words: int, dev):
        x = rng.integers(0, 1 << 64, size=words, dtype=np.uint64)
        idx = rng.integers(0, words, size=max(1, words // 64))
        x[idx] = FIELD_EDGES[idx % len(FIELD_EDGES)]
        self.rng, self.words = rng, gt.from_u64(x, dev)

    def make(self, n: int) -> torch.Tensor:
        start = int(self.rng.integers(0, self.words.numel() - n + 1))
        return self.words[start:start + n]


def field_pool(rng, keys, dev) -> FieldPool:
    return FieldPool(rng, max((key_words(k) for k in keys), default=1) + 4096, dev)


def check_field(keys, rng, dev, err: dict) -> int:
    """Each FIELD_SHAPES key's call through its kernel against the plain
    version (goldilocks_torch) on the same inputs, bit for bit; raises
    on a difference.  Returns the number of keys checked."""
    pool = field_pool(rng, keys, dev)
    for key in sorted(keys, key=repr):
        fn, args = gc.call_of(key, pool.make)
        got = fn(*args)
        want = gc.plain_of(key[0])(*args)
        torch.cuda.synchronize()
        family = gc.FAMILY_OF[key[0]]
        if not torch.equal(got, want):
            require_equal(f"{FIELD_RECORDS[family][0]} {key}", got, want)
        err.setdefault(family, 0)
    return len(keys)


def phase_field(state) -> None:
    """K4-K7 against their plain versions at every (op, shape, strides)
    that the warm proves of the prove phase launched: the zk Wormhole's
    first, then the other circuits'."""
    dev = torch.device("cuda")
    runs = state["runs"]
    keys = set().union(*(r["field_shapes"] for r in runs.values()))
    # the S-box alone, which the round ops fold in, at the round's shape
    m = state["common"].lde_size
    keys.add(("pow7", (12, m), ((m, 1),), None))
    with Phase("kernels (field, K4-K7)"):
        n = check_field(keys, np.random.default_rng(14), dev, state["max_abs_err"])
    state["field_checked"] = keys
    by_op = Counter(k[0] for k in keys)
    log(f"kernels (field): bit-exact against the plain torch versions at {n} (op, shape, "
        f"strides) keys of {len(runs)} warm proves, inputs with 0, 1, p-1, 2^63 and "
        f"2^64-1 planted: " + ", ".join(f"{op} {c}" for op, c in sorted(by_op.items())))


# tests/test_torch_threefry.py's seeds, and K8's shapes: the leaf's and
# the chunk's salts (lde_size, 4), the Wormhole's wires, and an odd count
THREEFRY_SEEDS = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1] + [
    int(s) for s in np.random.default_rng(20261017).integers(0, 1 << 63, size=3, dtype=np.uint64)]
THREEFRY_SHAPES = [(1,), (7, 4), (1000, 135), (65536, 4), (262144, 4), (1001, 3)]
THREEFRY_TIMED = [(65536, 4), (262144, 4)]
# about 75 32-bit integer instructions an element (threefry.cu), at the
# card's rate of 32-bit integer instructions (as chain_ms)
THREEFRY_INSTRUCTIONS = 75
INT32_PER_S = 16.727e12


def queued_ms(fn, iters: int = 50) -> float:
    """Mean device time of fn() in ms with the launches queued ahead of
    the card: a sleep kernel holds the stream while the host enqueues
    them, so that the host's launch rate does not set the time of a
    launch shorter than its own Python (a draw cannot be captured in a
    graph, as graph_ms would)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # about 10 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_threefry(state) -> None:
    """K8 against the plain draw on the CPU, bit for bit, over the test
    seeds at THREEFRY_SHAPES, one launch a draw and none for an empty
    one; then its time at the salts' shapes beside its bound and the
    plain version's on the card."""
    dev = torch.device("cuda")
    with Phase("kernels (threefry, K8)"):
        for seed in THREEFRY_SEEDS:
            sub = threefry.split(threefry.prng_key(seed))[1]
            for shape in THREEFRY_SHAPES:
                before = tc.LAUNCHES["threefry_draw"]
                got = threefry.random_bits_u64_shr1(sub, shape, dev)
                if tc.LAUNCHES["threefry_draw"] - before != 1:
                    raise AssertionError(f"K8 {shape}: not one launch")
                torch.cuda.synchronize()
                require_equal(f"K8 seed {seed} {shape}", got,
                              threefry.plain_bits_u64_shr1(sub, shape, "cpu"))
        before = tc.LAUNCHES["threefry_draw"]
        empty = threefry.random_bits_u64_shr1(sub, (0, 4), dev)
        if tuple(empty.shape) != (0, 4) or tc.LAUNCHES["threefry_draw"] != before:
            raise AssertionError("K8: an empty draw launched or lost its shape")
    log(f"kernels (threefry): K8 bit-exact against the plain draw on the CPU at "
        f"{len(THREEFRY_SEEDS)} seeds x {THREEFRY_SHAPES}, one launch a draw, none for (0, 4)")
    records = []
    for shape in THREEFRY_TIMED:
        n = int(np.prod(shape))

        def k8(shape=shape):
            return threefry.random_bits_u64_shr1(sub, shape, dev)

        def plain(shape=shape):
            return threefry.plain_bits_u64_shr1(sub, shape, dev)

        require_equal(f"plain draw on the card {shape}", plain(), k8())
        rec = {"kernel": "K8 threefry_draw", "shape": list(shape),
               "ms_events_10": cuda_ms(k8), "ms_queued_50": queued_ms(k8),
               "plain_ms": cuda_ms(plain),
               "bytes_bound_ms": 8 * n / 3.35e12 * 1e3,
               "instr_bound_ms": THREEFRY_INSTRUCTIONS * n / INT32_PER_S * 1e3}
        rec["bound_ms"] = max(rec["bytes_bound_ms"], rec["instr_bound_ms"])
        records.append(rec)
        log(f"K8 {shape}: {rec['ms_events_10']:.6f} ms a draw (CUDA events around 10, "
            f"host-paced), {rec['ms_queued_50']:.6f} ms queued (50 behind a sleep); bound "
            f"{rec['bound_ms']:.6f} ms (8n bytes {rec['bytes_bound_ms']:.6f}, instructions "
            f"{rec['instr_bound_ms']:.6f}); plain on the card {rec['plain_ms']:.4f} ms")
    log(json.dumps({"threefry": records}))


def field_work(key) -> tuple[int, int, int]:
    """(bytes, 32-bit multiplies, dependent 32-bit multiply-adds a
    thread) of one call of a FIELD_SHAPES key: each operand's distinct
    words read once and the output written once; five multiplies a
    field multiply (INT_MULS_PER_MULMOD)."""
    op, shape, strides, extra = key
    mm = INT_MULS_PER_MULMOD

    def distinct(shp, st):
        return int(np.prod([n for n, s in zip(shp, st) if s != 0], dtype=np.int64))

    numel = int(np.prod(shape, dtype=np.int64))
    inv_chain = 72  # the addition chain's dependent multiplies (63 squarings, 9 products)
    if op in ("mds_full", "mds_partial"):
        # the state's words read once (mds_partial: row 0 from x0, rows
        # 1-11 from x), 12 m written; a column's 144 products of a word's
        # two 32-bit halves by an MDS entry (2 multiplies each), one
        # multiply a lane's reduction, and the S-box's 4 field multiplies
        # on 12 words (full) or 1 (partial); chain: the S-box's 3 dependent
        # multiplies, the sum and the reduction
        m = shape[1]
        if op == "mds_full":
            read, sboxes = distinct(shape, strides[0]), 12
        else:
            read, sboxes = distinct(shape[1:], strides[0]) + distinct((11, m), strides[1]), 1
        muls = m * (2 * 144 + 12 + sboxes * 4 * mm)
        return 8 * (read + numel), muls, 2 * 3 + 2
    if op == "dot_mod":
        k = shape[extra]
        lanes = numel // max(1, k)
        read = distinct(shape, strides[0]) + distinct(shape, strides[1])
        return 8 * (read + lanes), mm * numel, 2
    if op == "prod_chunks":
        axis, chunk = extra
        k = shape[axis]
        lanes, runs = numel // max(1, k), -(-k // chunk)
        # k - runs multiplies a lane make its runs' products
        return (8 * (distinct(shape, strides[0]) + lanes * runs), mm * lanes * (k - runs),
                2 * max(0, min(chunk, k) - 1))
    if op in ("powers_vec", "ext_powers", "powers_vec_multi", "ext_powers_multi"):
        # n - 1 products make a base's n powers, whatever order a kernel
        # takes; the chain: b^(n-1) takes log2(n) dependent squarings
        bases, n = (shape[0], shape[1]) if op.endswith("_multi") else (1, shape[0])
        ext = op.startswith("ext")
        chain = max(1, (n - 1).bit_length()) * 2 * (3 if ext else 1)
        return (8 * (numel + bases * (1 + ext)), mm * (5 if ext else 1) * bases * max(0, n - 1),
                2 * chain)
    if op == "batch_divide_axis":
        # k - 1 products a lane's total, one inverse, 2 (k - 1) to the
        # words' inverses and k by the numerators; the chain: a tree
        # product of the lane, the inverse and a tree back
        axis = extra
        k = shape[axis]
        lanes = numel // max(1, k)
        read = distinct(shape, strides[0]) + distinct(shape, strides[1])
        return (8 * (read + numel), mm * lanes * (4 * k - 3 + inv_chain),
                2 * (2 * max(1, (k - 1).bit_length()) + inv_chain))
    if op in ("sum_mod", "batch_inverse_axis", "prefix_prod_exclusive"):
        axis = extra or 0
        k = shape[axis]
        lanes = numel // max(1, k)
        read = distinct(shape, strides[0])
        if op == "sum_mod":
            return 8 * (read + lanes), 0, 0
        if op == "prefix_prod_exclusive":
            # n - 1 multiplies a lane; the chain of a scan over the T
            # threads of the kernel's block: a chunk's walk, then log2(T)
            t = gc.prefix_threads(k)
            chain = -(-k // t) + t.bit_length() - 1
            return 8 * (read + numel), mm * lanes * max(0, k - 1), 2 * chain
        return (8 * (read + numel), mm * lanes * (3 * k - 3 + inv_chain),
                2 * (2 * max(1, (k - 1).bit_length()) + inv_chain))
    read = sum(distinct(shape, st) for st in strides)
    muls = {"add": 0, "sub": 0, "neg": 0, "mul": 1, "square": 1, "mul_small": 1,
            "reduce128": 0.2, "ext_mul": 5 / 2, "pow7": 4, "inverse": inv_chain,
            "ext_inverse_vec": (inv_chain + 5) / 2}[op]  # field multiplies an output word
    chain = {"inverse": inv_chain, "ext_inverse_vec": inv_chain + 4, "pow7": 3}.get(op, 1)
    return 8 * (read + numel), int(mm * muls * numel), 2 * chain


def time_field(counts: Counter, rng, dev) -> list[dict]:
    """Each key of a warm prove's FIELD_SHAPES: the kernel's time
    (graph_ms), the plain version's (CUDA events, 2 calls) and the bound,
    with the key's count in the prove."""
    pool = field_pool(rng, counts, dev)
    rows = []
    for key, count in sorted(counts.items(), key=lambda kv: repr(kv[0])):
        fn, args = gc.call_of(key, pool.make)
        plain = gc.plain_of(key[0])
        nbytes, ops, chain = field_work(key)
        bound, by = bound_ms(nbytes, ops)
        rows.append({"op": key[0], "family": gc.FAMILY_OF[key[0]], "shape": list(key[1]),
                     "strides": [list(s) for s in key[2]], "extra": key[3], "count": count,
                     "ms": graph_ms(lambda: fn(*args)),
                     "plain_ms": cuda_ms(lambda: plain(*args), iters=2, warmup=1),
                     "bound_ms": bound, "bound_by": by, "chain_bound_ms": chain_ms(chain),
                     "library_ms": None})
    return rows


def time_batch_groups(row, dev) -> dict:
    """batch_divide_axis at a field_shapes row's key, timed (graph_ms)
    at each thread count a lane of BATCH_GROUP_SWEEP; the wrapper's own
    count is the kernel's default (field.cu's qzk_batch_group)."""
    lib = gc._lib()
    key = ("batch_divide_axis", tuple(row["shape"]), tuple(tuple(s) for s in row["strides"]),
           row["extra"])
    _, (nums, dens, axis) = gc.call_of(key, field_pool(np.random.default_rng(16), [key],
                                                       dev).make)
    plan = gc.lane_plan("batch_divide_axis", dens, axis, nums)
    want = gt.batch_divide_axis(nums, dens, axis)
    out = {}
    for log_g in BATCH_GROUP_SWEEP:
        def call():
            return gc._launch(plan.key, plan.out_shape, dev, lambda lib_, o, s: (
                gc.launch_batch_inverse(lib, plan, dens, o, s, nums, log_g)))
        require_equal(f"batch_divide_axis G={1 << log_g}", call(), want)
        out[str(1 << log_g)] = graph_ms(call)
    default = 1 << gc.batch_group(lib, plan.n)
    log(f"K5 batch_divide_axis {list(row['shape'])} by threads a lane (graph_ms; default "
        f"{default}): " + ", ".join(f"G={g} {ms:.6f} ms" for g, ms in out.items()))
    return {"default": default, **out}


def chain_ms(imads: int) -> float:
    """A chain of dependent 32-bit multiply-adds at IMAD_LATENCY_CLOCKS
    each, on the clock that peak_int_muls reads."""
    clock_hz = peak_int_muls() / (INT_MULS_PER_CLOCK_PER_SM
                                  * torch.cuda.get_device_properties(0).multi_processor_count)
    return imads * IMAD_LATENCY_CLOCKS / clock_hz * 1e3


def field_records(state, rec) -> list[dict]:
    """The K4-K7 records of the kernels line: each family at its most
    costly key of the warm zk prove among the keys of its redesign's ops
    (REDESIGNED_OPS; by the bound), with sums over the prove's launches,
    in all and by op, the key of BESIDE_OPS beside K5's, and K5's key
    timed at each thread count a lane of BATCH_GROUP_SWEEP; for
    AGG_FAMILIES, the same at the keys of the warm (2, 1) chunk prove.
    Every key's row is logged as one JSON line, {"field_shapes": [...]}
    ({"field_shapes_agg": [...]} for the chunk's)."""
    dev = torch.device("cuda")
    rows = time_field(state["runs"]["wormhole_zk"]["field_shapes"],
                      np.random.default_rng(15), dev)
    log(json.dumps({"field_shapes": rows}))
    agg_rows = time_field(Counter({k: c for k, c in
                                   state["agg_runs"]["agg_2_1"]["field_shapes"].items()
                                   if gc.FAMILY_OF[k[0]] in AGG_FAMILIES}),
                          np.random.default_rng(17), dev)
    log(json.dumps({"field_shapes_agg": agg_rows}))
    records = []
    for fam, (name, replaces) in FIELD_RECORDS.items():
        mine = [r for r in rows if r["family"] == fam]
        top = max([r for r in mine if r["op"] in REDESIGNED_OPS] or mine,
                  key=lambda r: r["bound_ms"])
        r = rec(name, "qzk_tpu_torch/ops/csrc/field.cu", replaces, fam, top["ms"],
                top["plain_ms"], 0, 0, [top["op"], top["shape"], top["strides"]])
        r.update(bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                 chain_bound_ms=top["chain_bound_ms"], key_count=top["count"])
        beside = [x for x in mine if x["op"] == BESIDE_OPS.get(fam)]
        if beside:
            b = max(beside, key=lambda x: x["bound_ms"])
            r["beside"] = {k: b[k] for k in ("op", "shape", "count", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "chain_bound_ms")}
            log(f"{name} beside: {b['op']} {b['shape']} {b['ms']:.6f} ms (bound "
                f"{b['bound_ms']:.6f}, chain {b['chain_bound_ms']:.6f}), {b['count']} a prove")
        if top["op"] == "batch_divide_axis":
            r["batch_group_ms"] = time_batch_groups(top, dev)
        mine_agg = [x for x in agg_rows if x["family"] == fam]
        if mine_agg:
            a = max(mine_agg, key=lambda x: x["bound_ms"])
            r["agg"] = {k: a[k] for k in ("op", "shape", "count", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "chain_bound_ms")}
            r.update({f"prove_{k}_agg": sum(x["count"] * x[k] for x in mine_agg)
                      for k in ("ms", "bound_ms", "chain_bound_ms")})
            log(f"{name} per warm (2, 1) chunk prove: {sum(x['count'] for x in mine_agg)} calls, "
                f"{r['prove_ms_agg']:.4f} ms (bound {r['prove_bound_ms_agg']:.4f} ms); costliest "
                f"key {a['op']} {a['shape']} {a['ms']:.6f} ms (bound {a['bound_ms']:.6f})")
        ops = {}
        for op in gc.FAMILIES[fam]:
            sel = [x for x in mine if x["op"] == op]
            if sel:
                ops[op] = {"calls": sum(x["count"] for x in sel), "shapes": len(sel),
                           **{f"prove_{k}": sum(x["count"] * x[k] for x in sel)
                              for k in ("ms", "plain_ms", "bound_ms", "chain_bound_ms")}}
        r.update({f"prove_{k}": sum(x["count"] * x[k] for x in mine)
                  for k in ("ms", "plain_ms", "bound_ms", "chain_bound_ms")})
        r["ops"] = ops
        log(f"{name} per warm zk prove: {len(mine)} keys, {sum(x['count'] for x in mine)} "
            f"calls, {r['prove_ms']:.4f} ms (plain {r['prove_plain_ms']:.4f} ms, bound "
            f"{r['prove_bound_ms']:.4f} ms); by op: " + "; ".join(
                f"{op} {v['calls']} calls {v['prove_ms']:.4f} ms (bound "
                f"{v['prove_bound_ms']:.4f})" for op, v in ops.items()))
        records.append(r)
    return records


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
    runs = {"": state["runs"]["wormhole_zk"], "_nonzk": state["runs"]["wormhole_nonzk"],
            "_agg": state["agg_runs"]["agg_2_1"],
            "_sharded4": state["sharded_runs"]["wormhole_zk_sharded4"],
            "_sharded8": state["sharded_runs"]["wormhole_nonzk_sharded8"]}
    k1_prove = {tag: time_k1_per_prove(r["k1_shapes"], rng, dev) for tag, r in runs.items()}
    b = 1 << 18
    states = edge_rows(rng, b, 12, dev)
    k2_ms = cuda_ms(lambda: pc.permute(states))
    k2_plain = cuda_ms(lambda: pt.permute(states), iters=2, warmup=1)
    k2_bytes = 2 * states.numel() * 8
    k2_ops = b * INT_MULS_PER_PERM
    # K2 at (1, 12): each duplex of the device challenger, launched from
    # the fused prove's graph
    one = edge_rows(rng, 1, 12, dev)
    k2_one = {"ms_1x12": cuda_ms(lambda: pc.permute(one)),
              "graph_ms_1x12": graph_ms(lambda: pc.permute(one)),
              "plain_ms_1x12": cuda_ms(lambda: pt.permute(one), iters=5, warmup=1),
              "bound_ms_1x12": chain_bound_ms(),
              "bound_by_1x12": "dependent chain"}
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
            "launches_by_path": {p: r["launches"][key] for p, r in
                                 {**state["runs"], **state["agg_runs"],
                                  **state["artifact_runs"],
                                  **state["sharded_runs"]}.items()},
        }

    labels = {"": "zk", "_nonzk": "non-zk", "_agg": "(2, 1) chunk",
              "_sharded4": "zk sharded (4 shards)", "_sharded8": "non-zk sharded (8 shards)"}

    def add_per_prove(record, per_prove):
        for tag, (total, shapes, bound) in per_prove.items():
            record.update({f"prove_ms{tag}": total, f"prove_shapes{tag}": shapes,
                           f"prove_bound_ms{tag}": bound})
            log(f"{record['name'].split()[0]} per warm {labels[tag]} prove: "
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
    k2 = rec("K2 permute", "qzk_tpu_torch/ops/csrc/poseidon.cu",
             "qzk_tpu/ops/poseidon_pallas.py:275", "permute", k2_ms, k2_plain,
             k2_bytes, k2_ops, [b, 12])
    k2.update(k2_one)
    # per warm fused prove: one 2^18 PoW batch and a (1, 12) launch for
    # each duplex, the duplexes replayed from the graph
    for tag, name in (("", "wormhole_zk"), ("_agg", "agg_2_1")):
        duplexes = state["graphs"][name]["duplexes"]
        k2[f"duplexes{tag}"] = duplexes
        k2[f"prove_ms{tag}"] = k2_ms + duplexes * k2_one["graph_ms_1x12"]
        k2[f"prove_bound_ms{tag}"] = k2["bound_ms"] + duplexes * k2_one["bound_ms_1x12"]
        log(f"K2 per warm {labels[tag]} fused prove: 1 batch of 2^18 and {duplexes} duplexes at "
            f"(1, 12), {k2[f'prove_ms{tag}']:.4f} ms (bound {k2[f'prove_bound_ms{tag}']:.4f} ms)")
    return [k1, k2, k3, *field_records(state, rec)]


# The bound of one permutation in one thread (K2 at (1, 12)) is its
# dependent chain, not a throughput: 30 rounds, each at least three
# dependent field multiplies in the S-box (x^2, x^4 = (x^2)^2, x^7 =
# x^4 * x^3), each at least two dependent 32-bit multiply-adds (a partial
# product, then the reduction's), and one more for the MDS layer's sum;
# at 4 clocks a dependent integer multiply-add and the clock that
# benches/kernels.py's peak_int_muls reads.
CHAIN_IMADS = 30 * (3 * 2 + 1)
IMAD_LATENCY_CLOCKS = 4


def chain_bound_ms() -> float:
    return chain_ms(CHAIN_IMADS)


# The circuits the run proves: the zk Wormhole is the main path.
PATHS = ("wormhole_zk", "wormhole_nonzk", "voting_nonzk", "voting_zk")
KERNELS = ("hash_rows", "permute", "ntt_axis0", *gc.LAUNCHES)


def _pins() -> dict:
    from qzk_tpu_torch.models.voting import fixtures as vfix
    from qzk_tpu_torch.models.wormhole import fixtures as wfix

    return {"wormhole_zk": wfix.WORMHOLE_ZK_PROOF_SHA256,
            "wormhole_nonzk": wfix.WORMHOLE_NONZK_PROOF_SHA256,
            "voting_nonzk": vfix.VOTING_NONZK_PROOF_SHA256,
            "voting_zk": vfix.VOTING_ZK_PROOF_SHA256}


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
    build_chunk_circuits(state, configs["nonzk"])


def build_chunk_circuits(state, nonzk_config) -> None:
    """The aggregator's chunk circuits, each built once on the host and
    timed: branching 1 over the square test circuit, branching 2 over
    the zk Wormhole."""
    from qzk_tpu_torch.models.wormhole import aggregator as agg
    from qzk_tpu_torch.models.wormhole.fixtures import square_circuit

    state["square"] = square_circuit(nonzk_config)
    children = {"square_chunk": (state["square"][0].common, 1),
                "agg_2_1": (state["common"], 2)}
    state["chunks"] = {}
    for name, (common, branching) in children.items():
        with Phase(f"chunk circuit {name} (host build)"):
            chunk = agg.build_chunk_circuit(common, branching)
        state["chunks"][name] = chunk
        log(f"chunk circuit {name}: branching {branching} over a 2^{common.degree_bits}-row "
            f"child, degree 2^{chunk.data.common.degree_bits}, "
            f"zk {chunk.data.common.config.zero_knowledge}")


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


def require_pin(what: str, proof, pin: str) -> None:
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    if digest != pin:
        raise AssertionError(f"{what} sha256 {digest} != {pin}")
    log(f"{what}: sha256 {digest} matches the JAX package's")


def counted(path: str, fn):
    """fn() with the kernel launches counted from 0; every kernel must
    have been launched on `path`.  Returns fn's result and the counts."""
    pc.reset_launches()
    nc.reset_launches()
    gc.reset_launches()
    tc.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = {**pc.LAUNCHES, **nc.LAUNCHES, **gc.LAUNCHES, **tc.LAUNCHES}
    for key in KERNELS:
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} was not launched on the {path} path")
    return out, launches


def launch_text(launches) -> str:
    return (f"launches K1 {launches['hash_rows']}, K2 {launches['permute']}, "
            f"K3 {launches['ntt_axis0']}, K4 {launches['field_map']}, "
            f"K5 {launches['field_inverse']}, K6 {launches['field_powers']}, "
            f"K7 {launches['field_reduce']}, K8 {launches['threefry_draw']}")


def require_draws(name: str, timer, launches) -> None:
    """One K8 launch for each blinding.draw span of the prove timed by
    `timer` (none without zero knowledge)."""
    draws = sum(s.name == "blinding.draw" for s in spans.spans_of(timer))
    if launches["threefry_draw"] != draws:
        raise AssertionError(f"{name}: {launches['threefry_draw']} K8 launches for {draws} "
                             "blinding.draw spans")
    log(f"{name}: {draws} blinding.draw spans, {draws} K8 launches")


def fused_graph(prover_only, zk: bool):
    """(the fused pipeline's CUDA graph, the context) of a circuit on the
    card."""
    from qzk_tpu_torch.plonk import device_prover as dp

    ctx = prover_only._torch_ctxs[str(dp.context_device("cuda"))]
    return ctx._full_fns[zk], ctx


def log_capture(state, name, prover_only, zk) -> None:
    """Logs and records the capture of a circuit's fused graph."""
    graph, ctx = fused_graph(prover_only, zk)
    state["graphs"][name] = {"warmup_s": graph.warmup_s, "capture_s": graph.capture_s,
                             "reserved_growth": graph.reserved_growth,
                             "duplexes": ctx.duplexes[zk]}
    log(f"graph {name}: eager warm-up {graph.warmup_s:.3f} s, capture {graph.capture_s:.3f} s, "
        f"torch.cuda.memory_reserved grew {graph.reserved_growth / 2**30:.3f} GiB over the "
        f"capture; {ctx.duplexes[zk]} challenger duplexes a prove")


def one_replay(prover_only, zk: bool, name: str):
    """fn -> fn's result, holding that fn replayed the circuit's graph
    exactly once."""
    graph, _ = fused_graph(prover_only, zk)

    def run(fn):
        before = graph.replays
        out = fn()
        if graph.replays - before != 1:
            raise AssertionError(f"{name}: {graph.replays - before} graph replays, not 1")
        log(f"{name}: 1 graph replay in the warm prove")
        return out
    return run


def count_syncs(fn) -> int:
    """The synchronising CUDA calls that fn() makes, as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def drive(state, name) -> None:
    """Prove circuit `name` once, then once warm with its phases timed
    and the kernel launches counted from 0; every kernel must have been
    launched, the warm prove must be one graph replay and the proof's
    sha256 must be the JAX package's."""
    from qzk_tpu_torch.plonk.prover import PhaseTimer

    prove = prover_of(state, name)
    data = state["circuits"][name][0]
    zk = data.common.config.zero_knowledge
    with Phase(f"prove {name} (first, includes per-circuit device setup and graph capture)"):
        prove()
    log_capture(state, name, data.prover_only, zk)
    timer = PhaseTimer(cuda_events=True)
    with Phase(f"prove {name} (warm)") as ph:
        proof, launches = one_replay(data.prover_only, zk, name)(
            lambda: counted(name, lambda: prove(timer)))
    record_run(state["runs"], name, proof, prove, launches, ph.seconds, timer)
    require_draws(name, timer, launches)
    require_pin(f"prove {name}: proof", proof, _pins()[name])


def record_run(runs, name, proof, prove, launches, seconds, timer) -> None:
    runs[name] = {
        "proof": proof, "prove": prove, "launches": launches, "seconds": seconds,
        "k1_shapes": Counter(pc.K1_SHAPES), "k3_shapes": Counter(nc.K3_SHAPES),
        "field_shapes": Counter(gc.FIELD_SHAPES),
    }
    for phase, ms in timer.results():
        log(f"  prove {name} phase {phase}: {ms / 1e3:.4f} s")
    log(f"prove {name}: {seconds:.3f} s; {launch_text(launches)}")


def phase_prove(state) -> None:
    state["runs"], state["graphs"] = {}, {}
    drive(state, "wormhole_zk")
    syncs = count_syncs(state["runs"]["wormhole_zk"]["prove"])
    state["syncs"] = {"wormhole_zk": syncs}
    log(f"prove wormhole_zk: {syncs} synchronising CUDA calls in one warm fused prove "
        f"(torch.cuda.set_sync_debug_mode)")
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


def prove_chunk_timed(state, name, prove, chunk):
    """prove(timer) once, then once warm with its phases timed by CUDA
    events and the kernel launches counted from 0; every kernel must
    have been launched, and the warm prove of `chunk`'s circuit must be
    one graph replay.  Records the run under state["agg_runs"][name] and
    returns the warm result."""
    from qzk_tpu_torch.plonk.prover import PhaseTimer

    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with Phase(f"aggregate {name} (first, includes per-circuit device setup)"):
        prove(None)
    cold_peak = torch.cuda.max_memory_allocated()
    zk = chunk.data.common.config.zero_knowledge
    log_capture(state, name, chunk.data.prover_only, zk)
    replay_once = one_replay(chunk.data.prover_only, zk, name)
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer(cuda_events=True)
    with Phase(f"aggregate {name} (warm)") as ph:
        out, launches = replay_once(lambda: counted(name, lambda: prove(timer)))
    peak = torch.cuda.max_memory_allocated()
    state["agg_runs"][name] = {
        "launches": launches, "k1_shapes": Counter(pc.K1_SHAPES),
        "k3_shapes": Counter(nc.K3_SHAPES), "field_shapes": Counter(gc.FIELD_SHAPES),
    }
    for phase, ms in timer.results():
        log(f"  aggregate {name} phase {phase}: {ms / 1e3:.4f} s")
    log(f"aggregate {name}: {ph.seconds:.3f} s; {launch_text(launches)}; peak device memory "
        f"{cold_peak / 2**30:.3f} GiB first, {peak / 2**30:.3f} GiB warm "
        f"(torch.cuda.max_memory_allocated), of which {resident / 2**30:.3f} GiB were "
        f"allocated before (the earlier circuits' contexts, graphs and proofs)")
    require_draws(f"aggregate {name}", timer, launches)
    return out


def phase_aggregate(state) -> None:
    """The square chunk proof, then the (2, 1) tree over two zk Wormhole
    leaves, through the aggregator's entry points on the card."""
    from qzk_tpu_torch.models.wormhole import aggregator as agg
    from qzk_tpu_torch.models.wormhole import fixtures as wfix
    from qzk_tpu_torch.models.wormhole.prover import WormholeProver
    from qzk_tpu_torch.plonk.witness import PartialWitness

    state["agg_runs"] = {}
    sq_data, x = state["square"]
    sq_chunk = state["chunks"]["square_chunk"]
    pw = PartialWitness()
    pw.set_target(x, 5)
    child = sq_data.prove(pw, device="cuda")
    sq = prove_chunk_timed(state, "square_chunk", lambda timer: agg._prove_chunk(
        sq_chunk, [child], sq_data.verifier_only, "cuda", timer), chunk=sq_chunk)
    require_pin("square chunk proof", sq.proof, wfix.SQUARE_CHUNK_PROOF_SHA256)

    data, targets = state["circuits"]["wormhole_zk"]
    with Phase("prove wormhole_zk leaf with exit account 0x05"):
        leaf = WormholeProver(data.common.config, _circuit_data=data.prover_data(),
                              _targets=targets, device="cuda")
        leaf = leaf.commit(wfix.aggregation_leaf_inputs()[1]).prove()
    leaves = [state["runs"]["wormhole_zk"]["proof"], leaf]
    state["leaves"] = leaves
    tree = agg.TreeAggregationConfig.new(2, 1)

    def aggregate(timer=None):
        return agg.aggregate_to_tree(leaves, data.common, data.verifier_only, tree,
                                     device="cuda", timer=timer)

    root = prove_chunk_timed(state, "agg_2_1", aggregate, chunk=state["chunks"]["agg_2_1"])
    require_pin("(2, 1) aggregation root", root.proof, wfix.AGG_2_1_ZK_ROOT_SHA256)
    syncs = count_syncs(aggregate)
    state["syncs"]["agg_2_1"] = syncs
    log(f"aggregate agg_2_1: {syncs} synchronising CUDA calls in one warm fused tree "
        f"(torch.cuda.set_sync_debug_mode)")
    state["agg_runs"]["square_chunk"]["result"] = sq
    state["agg_runs"]["agg_2_1"]["result"] = root


# The sharded phase: meshes of shards on cuda:0, and (two cards or more)
# one shard a card.
SHARDED = (("wormhole_zk", 4), ("wormhole_nonzk", 8))
PRECONDITION_WARNING = ".*sharded-prove divisibility preconditions"


@contextlib.contextmanager
def active_mesh(mesh):
    """`mesh` active inside the block, with the sharded path's fallback
    to one device (the precondition warning) raised as an error."""
    from qzk_tpu_torch import parallel

    parallel.set_mesh(mesh)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=PRECONDITION_WARNING,
                                    category=RuntimeWarning)
            yield
    finally:
        parallel.set_mesh(None)


def sharded_proves(fn):
    """fn() -> (fn's result, the sharded proves it completed)."""
    from qzk_tpu_torch.parallel import prover_sharded as ps

    before = ps.PROVES["sharded_prove"]
    out = fn()
    return out, ps.PROVES["sharded_prove"] - before


def drive_sharded(state, name: str, d: int) -> None:
    """Circuit `name` over a mesh of d shards on cuda:0, first and warm;
    the warm prove's phases, launches and peak memory; the pin."""
    from qzk_tpu_torch.parallel import sharded
    from qzk_tpu_torch.plonk.prover import PhaseTimer

    key = f"{name}_sharded{d}"
    prove = prover_of(state, name)
    mesh = sharded.make_mesh(d, devices=[torch.device("cuda", 0)])
    resident = torch.cuda.memory_allocated()
    with active_mesh(mesh):
        torch.cuda.reset_peak_memory_stats()
        with Phase(f"sharded {key} (first, includes the sharded context)"):
            _, n_first = sharded_proves(prove)
        cold_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        timer = PhaseTimer(cuda_events=True)
        with Phase(f"sharded {key} (warm)") as ph:
            (proof, launches), n_warm = sharded_proves(lambda: counted(key, lambda: prove(timer)))
        peak = torch.cuda.max_memory_allocated()
    if (n_first, n_warm) != (1, 1):
        raise AssertionError(f"{key}: sharded_prove ran {n_first} and {n_warm} times, not 1 and 1")
    record_run(state["sharded_runs"], key, proof, prove, launches, ph.seconds, timer)
    require_draws(f"sharded {key}", timer, launches)
    state["sharded_runs"][key]["peak"] = (cold_peak, peak)
    log(f"sharded {key}: {mesh}; peak device memory {cold_peak / 2**30:.3f} GiB first, "
        f"{peak / 2**30:.3f} GiB warm (torch.cuda.max_memory_allocated), of which "
        f"{resident / 2**30:.3f} GiB were allocated before")
    require_pin(f"sharded {key}: proof", proof, _pins()[name])


def sharded_ntt(state) -> None:
    """The 2^22 NTT through ntt_sharded over 4 shards on cuda:0 against
    the single-device K3 result; both timed by CUDA events."""
    from qzk_tpu_torch.parallel import sharded
    from qzk_tpu_torch.parallel.ntt_sharded import ntt_sharded

    dev = torch.device("cuda", 0)
    n = 1 << BENCH_LOG_N
    x = np.random.default_rng(22).integers(0, gl.P, size=(1, n), dtype=np.uint64)
    coeffs = gt.from_u64(x, dev)
    mesh = sharded.make_mesh(4, devices=[dev])
    blocks = sharded.shard(coeffs, mesh, axis=-1)
    plan = nfs.get_fourstep_cuda_plan(BENCH_LOG_N)
    with Phase("sharded 2^22 NTT"):
        got, launches = counted_k3("sharded 2^22 NTT", lambda: ntt_sharded(blocks, mesh))
        require_equal("2^22 NTT, sharded over 4 shards vs single-device K3",
                      sharded.gather(got, axis=-1), plan.ntt(coeffs))
        ms = cuda_ms(lambda: ntt_sharded(blocks, mesh))
        single_ms = cuda_ms(lambda: plan.ntt(coeffs))
    state["sharded_ntt"] = {"ms": ms, "single_ms": single_ms, "k3_launches": launches}
    log(f"sharded 2^22 NTT over 4 shards on one card: equal to the single-device K3 NTT; "
        f"{launches} K3 launches; {ms:.4f} ms against {single_ms:.4f} ms on one device "
        f"(CUDA events, 10 calls)")


def counted_k3(what: str, fn):
    """fn() with K3's launches counted from 0; K3 must be launched."""
    nc.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    if nc.LAUNCHES["ntt_axis0"] <= 0:
        raise AssertionError(f"K3 was not launched by the {what}")
    return out, nc.LAUNCHES["ntt_axis0"]


def check_sharded_shapes(state) -> None:
    """K1 and K3 against their plain versions at every shape the warm
    sharded proves launched them with."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
    k1 = set().union(*(r["k1_shapes"] for r in state["sharded_runs"].values()))
    k3 = set().union(*(r["k3_shapes"] for r in state["sharded_runs"].values()))
    later = {**state["agg_runs"], **state["sharded_runs"]}
    field = set().union(*(r["field_shapes"] for r in later.values())) - state["field_checked"]
    err = state["max_abs_err"]
    with Phase("sharded kernel shapes"):
        check_field(field, rng, dev, err)
        for n, w in sorted(k1):
            x = edge_rows(rng, n, w, dev)
            got = pc.hash_no_pad_rows(x)
            torch.cuda.synchronize()
            err["hash_rows"] = max(err["hash_rows"], require_equal(
                f"K1 sharded shape ({n}, {w})", got, pt.hash_no_pad_batch(x)))
        for b, log_n, m, strided, tw in sorted(k3):
            rows = 1 << log_n
            x = canonical_rows(rng, (b, m, rows) if strided else (b, rows, m), dev)
            x = x.transpose(1, 2) if strided else x
            stw = gt.from_u64(ntp.stage_tw_table(log_n), dev)
            twiddle = canonical_rows(rng, (rows, m), dev) if tw else None
            err["ntt_axis0"] = max(err["ntt_axis0"], check_k3(
                f"K3 sharded shape ({b}, 2^{log_n}, {m}) strided={strided} twiddle={tw}",
                x, stw, twiddle))
    log(f"sharded kernel shapes: K1 at {len(k1)} shapes, K3 at {len(k3)}, K4-K7 at {len(field)} "
        f"(op, shape, strides) keys of the chunk and sharded proves not checked before, "
        f"bit-exact against the plain torch versions: K1 {sorted(k1)}; K3 {sorted(k3)}")


def multi_card(state) -> None:
    """With two cards or more: the zk Wormhole on a mesh of one shard a
    card at its pin, and a (2, 2) tree whose chunks fan out across the
    cards, its root equal to one worker's on one card."""
    from qzk_tpu_torch.models.wormhole import aggregator as agg
    from qzk_tpu_torch.parallel import sharded

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"sharded: {cards} card visible; the one-shard-a-card mesh and the (2, 2) tree "
            f"fanned out across cards need two cards or more, so neither ran")
        return
    d = 1 << min(3, cards.bit_length() - 1)  # a power of two the config allows
    mesh = sharded.make_mesh(d)
    prove = prover_of(state, "wormhole_zk")
    with active_mesh(mesh):
        with Phase(f"sharded wormhole_zk, one shard a card ({d} cards, first)"):
            _, n_first = sharded_proves(prove)
        with Phase(f"sharded wormhole_zk, one shard a card ({d} cards, warm)"):
            (proof, launches), n_warm = sharded_proves(
                lambda: counted("wormhole_zk_cards", prove))
    if (n_first, n_warm) != (1, 1):
        raise AssertionError("the one-shard-a-card prove did not run sharded_prove")
    log(f"sharded wormhole_zk over {mesh}: {launch_text(launches)}")
    require_pin(f"sharded wormhole_zk over {d} cards: proof", proof, _pins()["wormhole_zk"])

    data = state["circuits"]["wormhole_zk"][0]
    leaves = state["leaves"] * 2
    tree = agg.TreeAggregationConfig.new(2, 2)
    roots = {}
    for workers in (str(min(cards, 2)), "1"):
        old = os.environ.get("QZK_AGG_WORKERS")
        os.environ["QZK_AGG_WORKERS"] = workers
        try:
            with Phase(f"(2, 2) tree, {workers} worker(s)"):
                roots[workers] = agg.aggregate_to_tree(
                    leaves, data.common, data.verifier_only, tree, device="cuda:0")
        finally:
            if old is None:
                del os.environ["QZK_AGG_WORKERS"]
            else:
                os.environ["QZK_AGG_WORKERS"] = old
    fanned, single = (roots[k].proof.to_bytes() for k in (str(min(cards, 2)), "1"))
    if fanned != single:
        raise AssertionError("the (2, 2) root fanned out across cards != one worker's root")
    log(f"(2, 2) tree: chunks on {agg._chunk_devices(2, torch.device('cuda', 0))}; root sha256 "
        f"{hashlib.sha256(fanned).hexdigest()} equal to one worker's on one card")


def phase_sharded(state) -> None:
    state["sharded_runs"] = {}
    for name, d in SHARDED:
        drive_sharded(state, name, d)
    sharded_ntt(state)
    check_sharded_shapes(state)
    multi_card(state)


def require_sha256(what: str, blob: bytes, pin: str) -> None:
    digest = hashlib.sha256(blob).hexdigest()
    if digest != pin:
        raise AssertionError(f"{what} sha256 {digest} != {pin}")
    log(f"{what}: {len(blob)} bytes, sha256 {digest} matches the JAX package's")


def phase_artifacts(state) -> None:
    """The artifact layer: resume a prover and a verifier from files,
    an aggregation from the chunk circuit's disk cache, and the zk proof
    in the qp-plonky2 byte format."""
    import tempfile
    from pathlib import Path

    from qzk_tpu_torch.models.wormhole import fixtures as wfix
    from qzk_tpu_torch.models.wormhole.circuit_builder import generate_circuit_binaries
    from qzk_tpu_torch.models.wormhole.prover import WormholeProver
    from qzk_tpu_torch.models.wormhole.verifier import WormholeVerifier
    from qzk_tpu_torch.utils import serialization as ser

    state["artifact_runs"] = {}
    with Phase("artifacts"), tempfile.TemporaryDirectory(prefix="qzk_artifacts_") as tmp:
        t0 = time.perf_counter()
        paths = generate_circuit_binaries(Path(tmp) / "bins", include_prover_data=True)
        log(f"artifacts: generate_circuit_binaries (build and write): "
            f"{time.perf_counter() - t0:.3f} s")
        require_sha256("common.bin", paths["common"].read_bytes(), wfix.WORMHOLE_COMMON_BIN_SHA256)
        require_sha256("verifier.bin", paths["verifier"].read_bytes(),
                       wfix.WORMHOLE_VERIFIER_BIN_SHA256)
        t0 = time.perf_counter()
        prover_only = ser.prover_only_from_bytes(paths["prover"].read_bytes())
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (Path(tmp) / "prover_again.bin").write_bytes(ser.prover_only_to_bytes(prover_only))
        write_s = time.perf_counter() - t0
        log(f"artifacts: prover.bin {paths['prover'].stat().st_size} bytes; read and "
            f"unpickled in {read_s:.3f} s, pickled and written again in {write_s:.3f} s")
        del prover_only

        def prove_from_files():
            prover = WormholeProver.new_from_files(paths["prover"], paths["common"],
                                                   device="cuda")
            return prover.commit(wfix.synthetic_circuit_inputs()).prove()

        with Phase("artifacts: prove from files (first, includes the read and the "
                   "per-circuit device setup)") as ph:
            proof, launches = counted("wormhole_from_files", prove_from_files)
        state["artifact_runs"]["wormhole_from_files"] = {"launches": launches}
        log(f"artifacts: the first from-files prove {ph.seconds:.3f} s against the warm "
            f"non-zk prove {state['runs']['wormhole_nonzk']['seconds']:.3f} s; "
            f"{launch_text(launches)}")
        require_pin("artifacts: from-files proof", proof, wfix.WORMHOLE_NONZK_PROOF_SHA256)
        WormholeVerifier.new_from_files(paths["verifier"], paths["common"]).verify(proof)
        log("artifacts: WormholeVerifier.new_from_files accepts the from-files proof")

        resume_chunk_from_disk(state, Path(tmp) / "chunks")
        write_plonky2_proof(state)
        export_dummy_proofs(Path(tmp) / "generated-bins")


def export_dummy_proofs(outdir) -> None:
    """The port's dummy-proof tool on the card (its own circuit builds
    and first proves): dummy_proof_zk.bin and dummy_proof.bin held to the
    zk and non-zk Wormhole pins."""
    from qzk_tpu_torch.models.wormhole import fixtures as wfix
    from qzk_tpu_torch.tools import export_dummy_proof as tool

    with Phase("artifacts: export_dummy_proof (two circuit builds, first proves, verifies)"):
        zk_path, nonzk_path = tool.export(outdir, "cuda")
    require_sha256("export_dummy_proof: dummy_proof_zk.bin", zk_path.read_bytes(),
                   wfix.WORMHOLE_ZK_PROOF_SHA256)
    require_sha256("export_dummy_proof: dummy_proof.bin", nonzk_path.read_bytes(),
                   wfix.WORMHOLE_NONZK_PROOF_SHA256)


def resume_chunk_from_disk(state, cache_dir) -> None:
    """Write the proved (2, 1) chunk circuit through the disk cache,
    reload it with no host build, and aggregate the two leaves with it."""
    from qzk_tpu_torch.models.wormhole import aggregator as agg
    from qzk_tpu_torch.models.wormhole import fixtures as wfix

    chunk = state["chunks"]["agg_2_1"]
    if not getattr(chunk.data.prover_only, "_torch_ctxs", None):
        raise AssertionError("the (2, 1) chunk circuit holds no prover context to leave out")
    common = state["common"]
    digest = bytes(np.asarray(common.circuit_digest).tobytes())
    os.environ["QZK_CIRCUIT_CACHE_DIR"] = str(cache_dir)
    builds = []
    real_build = agg._build_chunk_circuit_uncached
    try:
        path = agg._chunk_cache_path(digest, 2)
        t0 = time.perf_counter()
        nbytes = agg._write_chunk_cache(path, chunk)
        write_s = time.perf_counter() - t0
        agg._chunk_circuit_cache.clear()
        agg._build_chunk_circuit_uncached = lambda *a: builds.append(a) or real_build(*a)
        t0 = time.perf_counter()
        loaded = agg.build_chunk_circuit(common, 2)
        load_s = time.perf_counter() - t0
    finally:
        agg._build_chunk_circuit_uncached = real_build
        os.environ["QZK_CIRCUIT_CACHE_DIR"] = ""
    if builds or loaded is chunk:
        raise AssertionError("the chunk circuit was built again, not loaded from the disk cache")
    if hasattr(loaded.data.prover_only, "_torch_ctxs"):
        raise AssertionError("the chunk-cache blob carries the prover contexts")
    log(f"artifacts: chunk circuit blob {path.name}: {nbytes} bytes, written in "
        f"{write_s:.3f} s, loaded in {load_s:.3f} s (no host build; the blob holds no "
        f"prover context)")
    data = state["circuits"]["wormhole_zk"][0]
    tree = agg.TreeAggregationConfig.new(2, 1)
    with Phase("artifacts: (2, 1) aggregation with the reloaded chunk circuit (first, "
               "includes the per-circuit device setup)"):
        root, launches = counted("agg_2_1_from_disk", lambda: agg.aggregate_to_tree(
            state["leaves"], data.common, data.verifier_only, tree, device="cuda"))
    state["artifact_runs"]["agg_2_1_from_disk"] = {"launches": launches}
    log(f"artifacts: (2, 1) aggregation with the reloaded chunk circuit: "
        f"{launch_text(launches)}")
    require_pin("artifacts: (2, 1) root from the reloaded chunk circuit", root.proof,
                wfix.AGG_2_1_ZK_ROOT_SHA256)


def write_plonky2_proof(state) -> None:
    """The card's zk Wormhole proof in the qp-plonky2 byte format, held
    to its pin and read back."""
    from qzk_tpu_torch.models.wormhole import fixtures as wfix
    from qzk_tpu_torch.utils import plonky2_compat as p2c
    from qzk_tpu_torch.utils import plonky2_write as p2w

    common = state["common"]
    proof = state["runs"]["wormhole_zk"]["proof"]
    p2_common = p2c.read_common(p2w.write_common(p2w.common_to_p2(common)))
    p2_proof = p2w.proof_to_p2(proof, common)
    blob = p2w.write_proof(p2_proof, p2_common)
    require_sha256("artifacts: zk proof in the plonky2 format", blob,
                   wfix.WORMHOLE_ZK_P2_PROOF_SHA256)
    back = p2c.read_proof(blob, p2_common)
    same = (np.array_equal(back.public_inputs, p2_proof.public_inputs)
            and np.array_equal(back.wires_cap, p2_proof.wires_cap)
            and np.array_equal(back.fri.final_poly, p2_proof.fri.final_poly)
            and back.fri.pow_witness == p2_proof.fri.pow_witness
            and p2w.write_proof(back, p2_common) == blob)
    if not same:
        raise AssertionError("the plonky2-format proof does not read back to the written one")
    log("artifacts: read_proof gives the written proof back")


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
        checks["(2, 1) root tampered public input"] = verify_aggregation(state)
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"the verifier accepted a proof with a {what}")
    log(f"verify: {', '.join(state['runs'])} proofs, the square chunk proof and the (2, 1) "
        f"root verify; the root's leaves parse back to exit accounts 0x04..., 0x05...; "
        f"rejected: {', '.join(checks)}")


def verify_aggregation(state) -> bool:
    """Verify the square chunk proof and the (2, 1) root on the host,
    parse the two leaves back from the root; True if the root with a
    tampered public input is rejected."""
    import copy

    from qzk_tpu_torch.models.wormhole.inputs import PublicCircuitInputs

    for run in state["agg_runs"].values():
        run["result"].circuit_data.verify(run["result"].proof)
    root = state["agg_runs"]["agg_2_1"]["result"]
    parsed = PublicCircuitInputs.try_from_aggregated(root.proof, 16, 2)
    exits = [bytes(p.exit_account) for p in parsed]
    if exits != [bytes([4] * 32), bytes([5] * 32)]:
        raise AssertionError(f"the root's leaves carry exit accounts {exits}")
    bad = copy.deepcopy(root.proof)
    bad.public_inputs[0] = np.uint64((int(bad.public_inputs[0]) + 1) % gl.P)
    return rejects(root.circuit_data.verify, bad)


def phase_report(state) -> None:
    graphs = state["graphs"]
    log(f"graphs: {len(graphs)} captured; memory_reserved growth over their captures "
        f"{sum(g['reserved_growth'] for g in graphs.values()) / 2**30:.3f} GiB in all; "
        f"torch.cuda.memory_reserved now {torch.cuda.memory_reserved() / 2**30:.3f} GiB, "
        f"max {torch.cuda.max_memory_reserved() / 2**30:.3f} GiB")
    log(json.dumps({"graphs": graphs, "syncs": state["syncs"]}))
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


def main_multicard(state) -> None:
    """python3 chip_smoke.py --multicard: only the checks that need two
    cards or more (multi_card), after the builds, the zk Wormhole circuit
    and its two aggregation leaves that they need."""
    from qzk_tpu_torch.models.wormhole import fixtures as wfix
    from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit
    from qzk_tpu_torch.models.wormhole.prover import WormholeProver
    from qzk_tpu_torch.plonk.config import CircuitConfig

    if torch.cuda.device_count() < 2:
        raise RuntimeError("--multicard needs two cards or more")
    phase_build(state)
    with Phase("circuit wormhole_zk"):
        circuit = WormholeCircuit(CircuitConfig.standard_recursion_zk_config())
        targets = circuit.targets()
        data = circuit.build_circuit()
    state.update(circuits={"wormhole_zk": (data, targets)}, common=data.common)
    with Phase("prove the two zk Wormhole leaves"):
        state["leaves"] = [
            WormholeProver(data.common.config, _circuit_data=data.prover_data(),
                           _targets=targets, device="cuda").commit(inputs).prove()
            for inputs in wfix.aggregation_leaf_inputs()]
    multi_card(state)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Keep every context the run builds resident (the six circuits it
    # proves and the square child), so that the warm proves of the
    # earlier paths stay warm; benches/aggregate.py's (2, 3) tree runs
    # the default limit's eviction.  The artifacts phase, after every
    # warm timing, adds two contexts and so evicts the least recent.
    os.environ["QZK_CTX_LIMIT"] = "8"
    # No chunk-circuit disk cache but the artifacts phase's own, in a
    # temporary directory: the checkout stays as it was.
    os.environ["QZK_CIRCUIT_CACHE_DIR"] = ""
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    state: dict = {}
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--multicard"]:
        main_multicard(state)
        log(f"[phase] total: {time.perf_counter() - t0:.3f} s")
        return 0
    for phase in (phase_build, phase_circuit, phase_kernels, phase_ntt, phase_prove,
                  phase_field, phase_threefry, phase_aggregate, phase_sharded, phase_artifacts,
                  phase_verify, phase_report):
        phase(state)
    log(f"[phase] total: {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
