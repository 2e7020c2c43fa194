"""Recursive proof-tree aggregation (parity with the reference's
aggregator crate: reference wormhole/aggregator/src/
{aggregator.rs:13-93, circuits/tree.rs:24-143, util.rs:11-29}), the
JAX package's qzk_tpu/models/wormhole/aggregator.py on the port.

Semantics match the reference: proofs are buffered up to
`num_leaf_proofs`, padded with a dummy proof, then aggregated level by
level — each chunk of `tree_branching_factor` proofs is verified inside
a fresh recursion circuit whose public inputs are the concatenation of
the children's public inputs, so the root proof carries
num_leaves x 16 felts parsed by PublicCircuitInputs.try_from_aggregated.

One deliberate improvement over the reference (SURVEY.md §7 pitfalls):
the reference rebuilds the recursion circuit for EVERY chunk at EVERY
level (tree.rs:106-143); we build ONE circuit per (level shape) and
reuse it for all chunks of that level — identical proof/PI semantics,
k× less build work.

Chunk proves run on the device the caller names: CUDA unless it passes
device="cpu".  Chunk circuits are memoized in memory and kept in a disk
cache (QZK_CIRCUIT_CACHE_DIR; see _chunk_cache_path), as in the JAX
package, so that a process whose cache holds a level shape loads it in
place of building it: a build is seconds of host Python, 1.8-2.2 s for
the branching-1 chunk over the square test circuit (2^13 rows) and
8.3-9.9 s for the branching-2 chunk over the zk Wormhole (2^15 rows), on
the host of an NVIDIA H100 80GB HBM3 machine (700 W limit;
chip_smoke.py, PERF.md).  The port's blobs pickle its own classes, so
their directory, file names and magic differ from the JAX package's:
each package finds only its own blobs, and refuses the other's.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import os
import pickle
import struct
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...plonk import recursion as rec
from ...plonk.builder import CircuitBuilder
from ...plonk.circuit_data import CircuitData, VerifierCircuitData
from ...plonk.config import CircuitConfig
from ...plonk.proof import ProofWithPublicInputs
from ...plonk.prover import Front, prove_front
from ...plonk.witness import PartialWitness
from ...utils import spans
from ...utils.device import resolve_device
from ..wormhole.inputs import PublicCircuitInputs

DEFAULT_TREE_BRANCHING_FACTOR = 2
DEFAULT_TREE_DEPTH = 3


@dataclass(frozen=True)
class TreeAggregationConfig:
    num_leaf_proofs: int
    tree_branching_factor: int
    tree_depth: int

    @classmethod
    def new(cls, tree_branching_factor: int, tree_depth: int):
        return cls(
            num_leaf_proofs=tree_branching_factor**tree_depth,
            tree_branching_factor=tree_branching_factor,
            tree_depth=tree_depth,
        )

    @classmethod
    def default(cls):
        return cls.new(DEFAULT_TREE_BRANCHING_FACTOR, DEFAULT_TREE_DEPTH)


@dataclass
class AggregatedProof:
    proof: ProofWithPublicInputs
    circuit_data: CircuitData


@dataclass
class _ChunkCircuit:
    data: CircuitData
    verifier_data_target: rec.VerifierCircuitTarget
    proof_targets: list  # branching ProofWithPisTargets


# (circuit_digest bytes, branching) -> _ChunkCircuit.  The recursion
# circuit depends only on the child-proof shape (common data) and the
# chunk size, so a proving service aggregating many batches builds each
# shape once per process (the reference rebuilds per chunk per level —
# tree.rs:106-143; we additionally reuse across aggregate() calls and,
# via the disk cache below, across processes).
_chunk_circuit_cache: dict = {}

# Bump when CircuitBuilder / recursion gadget output changes shape, so
# stale cached circuits are rebuilt rather than mis-proved.
_CHUNK_CACHE_VERSION = 1
# The JAX package's slot is .cache/chunk_circuits/chunk_{digest}_b{b}_v1.bin
# with magic b"QZKA\x01", for the same digests: the port's differs in
# all three, so that neither package unpickles the other's classes.
_MAGIC_CHUNK = b"QZTA\x01"
_DEFAULT_CACHE_DIR = Path(".cache") / "chunk_circuits_torch"


def _chunk_cache_path(digest: bytes, branching: int) -> Path | None:
    """Disk-cache slot for a chunk circuit (the recursion-circuit build
    is seconds of host Python per shape and dominates a cold
    aggregation; the proofs it produces are identical either way).
    QZK_CIRCUIT_CACHE_DIR overrides the default .cache/chunk_circuits_torch
    (relative to the working directory);
    QZK_CIRCUIT_CACHE_DIR="" disables disk caching."""
    root = os.environ.get("QZK_CIRCUIT_CACHE_DIR")
    if root == "":
        return None
    base = Path(root) if root else _DEFAULT_CACHE_DIR
    return base / (
        f"chunk_torch_{digest.hex()[:32]}_b{branching}_v{_CHUNK_CACHE_VERSION}.bin"
    )


def _chunk_circuit_to_bytes(circuit: _ChunkCircuit) -> bytes:
    from ...utils.serialization import circuit_data_to_bytes

    data_blob = circuit_data_to_bytes(circuit.data)
    targets_blob = pickle.dumps(
        (circuit.verifier_data_target, circuit.proof_targets), protocol=4
    )
    return (
        _MAGIC_CHUNK
        + struct.pack("<2Q", len(data_blob), len(targets_blob))
        + data_blob
        + targets_blob
    )


def _chunk_circuit_from_bytes(blob: bytes) -> _ChunkCircuit:
    from ...utils.serialization import circuit_data_from_bytes

    if blob[:5] != _MAGIC_CHUNK:
        raise ValueError("bad chunk-circuit cache blob")
    ld, lt = struct.unpack_from("<2Q", blob, 5)
    off = 5 + 16
    data = circuit_data_from_bytes(blob[off : off + ld])
    vd_t, proof_ts = pickle.loads(blob[off + ld : off + ld + lt])
    return _ChunkCircuit(
        data=data, verifier_data_target=vd_t, proof_targets=proof_ts
    )


def _write_chunk_cache(path: Path, circuit: _ChunkCircuit) -> int:
    """Write `circuit` to its slot through a temporary name of this
    process and thread, so that no reader finds half a blob; returns
    the blob's bytes."""
    blob = _chunk_circuit_to_bytes(circuit)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    tmp.write_bytes(blob)
    os.replace(tmp, path)
    return len(blob)


def build_chunk_circuit(common, branching: int) -> _ChunkCircuit:
    """The recursion circuit verifying `branching` child proofs and
    re-exporting their public inputs (tree.rs:106-127).  Memoized in
    memory and on disk, keyed by (child circuit digest, branching)."""
    digest = bytes(np.asarray(common.circuit_digest).tobytes())
    key = (digest, branching)
    cached = _chunk_circuit_cache.get(key)
    if cached is not None:
        return cached
    path = _chunk_cache_path(digest, branching)
    if path is not None and path.exists():
        circuit = _chunk_circuit_from_bytes(path.read_bytes())
        _chunk_circuit_cache[key] = circuit
        return circuit
    circuit = _build_chunk_circuit_uncached(common, branching)
    _chunk_circuit_cache[key] = circuit
    if path is not None:
        _write_chunk_cache(path, circuit)
    return circuit


def _build_chunk_circuit_uncached(common, branching: int) -> _ChunkCircuit:
    builder = CircuitBuilder(common.config)
    vd_t = rec.add_virtual_verifier_data(
        builder, common.config.fri_config.cap_height
    )
    proof_ts = []
    for _ in range(branching):
        pt = rec.add_virtual_proof_with_pis(builder, common)
        rec.verify_proof_circuit(builder, pt, vd_t, common)
        builder.register_public_inputs(pt.public_inputs)
        proof_ts.append(pt)
    data = builder.build()
    return _ChunkCircuit(
        data=data, verifier_data_target=vd_t, proof_targets=proof_ts
    )


def _fill(circuit: _ChunkCircuit, chunk: list, verifier_only) -> PartialWitness:
    """The chunk circuit's partial witness from the child proofs (the
    span "aggregation.fill": `children`, the proofs filled, and `values`,
    the targets set)."""
    pw = PartialWitness()
    with spans.span("aggregation.fill", attrs={"children": len(chunk)}):
        rec.set_verifier_data_target(
            pw, circuit.verifier_data_target, verifier_only
        )
        assert len(chunk) == len(circuit.proof_targets)
        for pt, proof in zip(circuit.proof_targets, chunk):
            rec.set_proof_with_pis_target(pw, pt, proof)
        spans.set_attrs(values=pw.num_values)
    return pw


def _chunk_front(circuit: _ChunkCircuit, chunk: list, verifier_only) -> Front:
    """The host front of a chunk prove (plonk/prover.py::prove_front):
    the fill, the generators, the public inputs and their hash, the
    blinding seed.  No CUDA call, so it may run beside another chunk's
    device part."""
    pw = _fill(circuit, chunk, verifier_only)
    return prove_front(circuit.data.common, circuit.data.prover_only, pw)


def _prove_chunk(
    circuit: _ChunkCircuit, chunk: list, verifier_only, device=None, timer=None,
    front: Front | None = None,
) -> AggregatedProof:
    """Prove the chunk circuit over the child proofs `chunk` on `device`,
    with `timer` (a plonk.prover.PhaseTimer) marking the prove's phases
    when given.  From `front` (_chunk_front) when the caller made it
    beforehand; else the witness is filled here and the generators run
    inside the prove.  Gives the span "aggregation.chunk" it is called in
    the attributes `children` (the proofs it verifies) and `degree_bits`
    (its circuit's rows, log 2)."""
    spans.set_attrs(children=len(chunk), degree_bits=circuit.data.common.degree_bits)
    pw = None if front is not None else _fill(circuit, chunk, verifier_only)
    proof = circuit.data.prove(pw, device=device, timer=timer, front=front)
    return AggregatedProof(proof=proof, circuit_data=circuit.data)


def _agg_workers(n_chunks: int, device: torch.device) -> int:
    """Concurrent chunk proves per level — the reference fans chunks
    out via rayon `par_chunks` with `multithread` on by default
    (tree.rs:79-103, aggregator/Cargo.toml).  Here a chunk prove is one
    device pipeline, so concurrency = one worker per card (per-device
    prover contexts, see plonk.device_prover.get_context); with one card
    proving is serialized and the levels are walked on the caller's
    thread (_walk).  On the CPU, 1: the chunk proves would share the
    host's cores.  QZK_AGG_WORKERS forces a count.  A level never has
    more workers than the level below it."""
    flag = os.environ.get("QZK_AGG_WORKERS")
    if flag:
        return max(1, min(int(flag), n_chunks))
    if device.type == "cpu":
        return 1
    return max(1, min(torch.cuda.device_count(), n_chunks))


def _chunk_devices(n_chunks: int, device: torch.device) -> list:
    """The device of each chunk's prove: the chunks go round the cards
    in order on CUDA, all to the CPU on the CPU."""
    if device.type == "cpu":
        return [device] * n_chunks
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_chunks)]


def _n_chunks(n_proofs: int, config: TreeAggregationConfig) -> int:
    return -(-n_proofs // config.tree_branching_factor)


def aggregate_level(
    proofs: list, common, verifier_only, config: TreeAggregationConfig,
    device=None, timer=None, level: int = 1,
) -> list:
    """One tree level (level 1 proves the leaves): chunked recursion
    proofs (tree.rs:79-103).  Builds one circuit per chunk size
    occurring at this level; chunks prove concurrently across cards
    when more than one is attached, each on the card it is given, else
    one after another on this thread (_walk).  The level is the span
    "aggregation.level", each chunk prove the span "aggregation.chunk"
    (utils/spans.py), when `timer` is given or a request is open.  On
    the one-worker path `timer` marks the phases of each chunk prove in
    turn; chunks that fan out record their spans in the worker threads
    and mark nothing."""
    dev = resolve_device(device)
    if _agg_workers(_n_chunks(len(proofs), config), dev) <= 1:
        return _walk(proofs, common, verifier_only, config, dev, timer, level, levels=1)
    b = config.tree_branching_factor
    chunks = [proofs[i : i + b] for i in range(0, len(proofs), b)]
    with spans.span("aggregation.level", timer=timer, level=level, chunks=len(chunks)):
        circuits: dict[int, _ChunkCircuit] = {}
        for chunk in chunks:
            size = len(chunk)
            if size not in circuits:
                circuits[size] = build_chunk_circuit(common, size)
        devices = _chunk_devices(len(chunks), dev)
        workers = _agg_workers(len(chunks), dev)

        def prove_on(i, chunk):
            with spans.span("aggregation.chunk", level=level, chunk=i, card=devices[i]):
                return _prove_chunk(circuits[len(chunk)], chunk, verifier_only, devices[i])

        # each task in a copy of this thread's context: its spans join
        # the open request
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            futures = [ex.submit(contextvars.copy_context().run, prove_on, i, chunk)
                       for i, chunk in enumerate(chunks)]
            return [f.result() for f in futures]


def _prefetched_front(level: int, chunk_index: int, circuit, chunk, verifier_only) -> Front:
    with spans.span("aggregation.prefetch", level=level, chunk=chunk_index):
        return _chunk_front(circuit, chunk, verifier_only)


def _walk(
    proofs: list, common, verifier_only, config: TreeAggregationConfig, dev, timer,
    level: int, levels: int | None = None,
) -> list:
    """Prove the tree from `level` on (down to one proof, or `levels`
    levels) on this thread, chunk by chunk in tree order, with one
    chunk's host front (_chunk_front) in flight on one helper thread: as
    soon as a chunk's front is in hand, the next chunk's is begun if
    every child of it is proved, and the chunk's device part runs here.
    Everything that touches the card stays on this thread, in the order
    of a prove alone, so the proofs are the same.  The helper's work is
    the span "aggregation.prefetch" (`level`, `chunk`), in the request
    of this thread; this thread's wait for it the span
    "aggregation.prefetch_wait", whose attribute `ready` is 1 when the
    front was done before it was asked for.  Returns the last level's
    proofs."""
    b = config.tree_branching_factor
    counts = [len(proofs)]  # proofs a level, the walk's input first
    while (len(counts) == 1 or counts[-1] > 1) and (levels is None or len(counts) <= levels):
        counts.append(_n_chunks(counts[-1], config))
    done: list = [proofs] + [[] for _ in counts[1:]]
    circuits: dict = {}
    order = [(j, i) for j in range(1, len(counts)) for i in range(counts[j])]

    def inputs(j, i):
        """(circuit, child proofs, their verifier data) of chunk i of
        the walk's level j; the level below is proved that far."""
        lo, hi = i * b, min((i + 1) * b, counts[j - 1])
        if j == 1:
            chunk, c, vo = proofs[lo:hi], common, verifier_only
        else:
            below = done[j - 1]
            chunk = [p.proof for p in below[lo:hi]]
            c, vo = below[0].circuit_data.common, below[0].circuit_data.verifier_only
        if (j, len(chunk)) not in circuits:
            circuits[j, len(chunk)] = build_chunk_circuit(c, len(chunk))
        return circuits[j, len(chunk)], chunk, vo

    def children_proved(j, i):
        return j == 1 or len(done[j - 1]) >= min((i + 1) * b, counts[j - 1])

    # the request the fronts' spans join: the caller's, else the one the
    # first level's span opens
    base = contextvars.copy_context() if spans.in_request() else None
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="qzk-prefetch"
    ) as helper:
        pending = None  # (circuit, chunk, verifier data, future) of the next chunk

        def submit(j, i):
            circuit, chunk, vo = inputs(j, i)
            return circuit, chunk, vo, helper.submit(
                base.copy().run, _prefetched_front, level + j - 1, i, circuit, chunk, vo)

        k = 0
        for j in range(1, len(counts)):
            with spans.span("aggregation.level", timer=timer, level=level + j - 1,
                            chunks=counts[j]):
                if base is None:
                    base = contextvars.copy_context()
                for i in range(counts[j]):
                    with spans.span("aggregation.chunk", level=level + j - 1, chunk=i,
                                    card=dev):
                        prefetched = pending is not None
                        circuit, chunk, vo, future = pending or submit(j, i)
                        with spans.span("aggregation.prefetch_wait",
                                        attrs={"ready": int(prefetched and future.done())}):
                            front = future.result()
                        k += 1
                        pending = (submit(*order[k]) if k < len(order)
                                   and children_proved(*order[k]) else None)
                        done[j].append(_prove_chunk(circuit, chunk, vo, dev, timer,
                                                    front=front))
    return done[-1]


def aggregate_to_tree(
    leaf_proofs: list, common, verifier_only, config: TreeAggregationConfig,
    device=None, timer=None,
) -> AggregatedProof:
    """tree.rs:55-77: aggregate level by level until one proof remains;
    the span "aggregate" when `timer` is given or a request is open.
    Levels with more than one worker fan out (aggregate_level); from the
    first level with one, the rest of the tree is one walk (_walk)."""
    dev = resolve_device(device)
    with spans.span("aggregate", timer=timer):
        proofs, level = leaf_proofs, 1
        while True:
            if _agg_workers(_n_chunks(len(proofs), config), dev) <= 1:
                out = _walk(proofs, common, verifier_only, config, dev, timer, level)
                break
            out = aggregate_level(proofs, common, verifier_only, config, dev, timer, level)
            if len(out) <= 1:
                break
            common, verifier_only = out[0].circuit_data.common, out[0].circuit_data.verifier_only
            proofs, level = [p.proof for p in out], level + 1
    assert len(out) == 1
    return out[0]


def pad_with_dummy_proofs(
    proofs: list, proof_len: int, dummy_proof: ProofWithPublicInputs | None
) -> list:
    """util.rs:11-29 — the reference embeds a pre-generated proof of the
    default test inputs; we take it from the aggregator's dummy-proof
    source (generated-bins/ or explicit)."""
    if len(proofs) > proof_len:
        raise ValueError(
            "proofs to aggregate was more than the maximum allowed"
        )
    if len(proofs) < proof_len:
        if dummy_proof is None:
            raise ValueError(
                "proof buffer not full and no dummy proof available "
                "(generate one with python3 -m qzk_tpu_torch.tools.export_dummy_proof)"
            )
        proofs = proofs + [dummy_proof] * (proof_len - len(proofs))
    return proofs


class WormholeProofAggregator:
    """aggregator.rs:13-93 session API.  Aggregates on `device`: CUDA
    unless the caller passes device="cpu"."""

    def __init__(
        self,
        leaf_circuit_data: VerifierCircuitData,
        config: TreeAggregationConfig | None = None,
        dummy_proof: ProofWithPublicInputs | None = None,
        device=None,
    ):
        self.leaf_circuit_data = leaf_circuit_data
        self.config = config or TreeAggregationConfig.default()
        self.proofs_buffer: list | None = []
        self._dummy_proof = dummy_proof
        self.device = device

    @classmethod
    def new(cls, verifier_circuit_data: VerifierCircuitData, device=None):
        return cls(verifier_circuit_data, device=device)

    @classmethod
    def from_circuit_config(cls, circuit_config: CircuitConfig, device=None):
        from .verifier import WormholeVerifier

        verifier = WormholeVerifier.new(circuit_config)
        return cls(verifier.circuit_data, device=device)

    @classmethod
    def default(cls, device=None):
        return cls.from_circuit_config(
            CircuitConfig.standard_recursion_zk_config(), device=device
        )

    def with_config(self, config: TreeAggregationConfig):
        self.config = config
        return self

    def push_proof(self, proof: ProofWithPublicInputs) -> None:
        if self.proofs_buffer is not None:
            if len(self.proofs_buffer) >= self.config.num_leaf_proofs:
                raise ValueError(
                    "tried to add proof when proof buffer is full"
                )
            self.proofs_buffer.append(proof)
        else:
            self.proofs_buffer = [proof]

    def extract_leaf_public_inputs(self, aggregated_proof) -> list:
        leaf_pi_len = self.leaf_circuit_data.common.num_public_inputs
        return PublicCircuitInputs.try_from_aggregated(
            aggregated_proof, leaf_pi_len, self.config.num_leaf_proofs
        )

    def _load_dummy_proof(self):
        if self._dummy_proof is not None:
            return self._dummy_proof
        zk = self.leaf_circuit_data.common.config.zero_knowledge
        name = "dummy_proof_zk.bin" if zk else "dummy_proof.bin"
        path = Path("generated-bins") / name
        if path.exists():
            return ProofWithPublicInputs.from_bytes(
                path.read_bytes(), self.leaf_circuit_data.common
            )
        return None

    def aggregate(self, timer=None) -> AggregatedProof:
        if self.proofs_buffer is None:
            raise ValueError("there are no proofs to aggregate")
        dev = resolve_device(self.device)
        proofs = self.proofs_buffer
        self.proofs_buffer = None
        padded = pad_with_dummy_proofs(
            proofs, self.config.num_leaf_proofs, self._load_dummy_proof()
        )
        return aggregate_to_tree(
            padded,
            self.leaf_circuit_data.common,
            self.leaf_circuit_data.verifier_only,
            self.config,
            dev,
            timer,
        )
