"""Circuit-data serialization (checkpoint/resume of the one-time circuit
build — the reference's common.bin / verifier.bin / prover.bin artifact
mechanism, SURVEY.md §5 "Checkpoint / resume"; reference
wormhole/circuit-builder/src/lib.rs:11-66), the JAX package's
qzk_tpu/utils/serialization.py on the port.

Common + verifier data use a compact deterministic binary format, byte
for byte the JAX package's (same magics), so that either package reads
the other's common.bin and verifier.bin.  The prover-only payload
(generator plan, slot maps, preprocessed LDE + Merkle tree) is a pickle
of the port's own classes — a local cache, never exchanged — so it has
a magic of its own, and each package refuses the other's blob before
unpickling anything.  It carries no device state: the prover contexts
that a prove leaves on the prover data (plonk.circuit_data) are left
out, so a blob written after a prove equals one written before it.
"""

from __future__ import annotations

import io
import pickle
import re
import struct

import numpy as np

from ..plonk import gates as gates_mod
from ..plonk.circuit_data import (
    CircuitData,
    CommonCircuitData,
    ProverCircuitData,
    ProverOnlyCircuitData,
    VerifierCircuitData,
    VerifierOnlyCircuitData,
)
from ..plonk.config import CircuitConfig, FriConfig

MAGIC_COMMON = b"QZKC\x01"
MAGIC_VERIFIER = b"QZKV\x01"
# The JAX package's prover-only magic is b"QZKP\x01": its blob pickles
# qzk_tpu classes, which the port cannot load.
MAGIC_PROVER = b"QZTP\x01"


def gate_from_gid(gid: str):
    if m := re.fullmatch(r"arithmetic<(\d+)>", gid):
        return gates_mod.ArithmeticGate(num_ops=int(m.group(1)))
    if gid == "poseidon<12>":
        return gates_mod.PoseidonGate()
    if m := re.fullmatch(r"bit_decomp<(\d+),(\d+)>", gid):
        return gates_mod.BitDecompGate(
            bits=int(m.group(1)), num_ops=int(m.group(2))
        )
    if m := re.fullmatch(r"constant<(\d+)>", gid):
        return gates_mod.ConstantGate(num_consts=int(m.group(1)))
    if gid == "public_input":
        return gates_mod.PublicInputGate()
    if gid == "noop":
        return gates_mod.NoopGate()
    raise ValueError(f"unknown gate id: {gid}")


def common_to_bytes(common: CommonCircuitData) -> bytes:
    buf = io.BytesIO()
    buf.write(MAGIC_COMMON)
    cfg = common.config
    fri = cfg.fri_config
    buf.write(
        struct.pack(
            "<12I",
            cfg.num_wires,
            cfg.num_routed_wires,
            cfg.num_constants,
            cfg.security_bits,
            cfg.num_challenges,
            1 if cfg.zero_knowledge else 0,
            cfg.max_quotient_degree_factor,
            fri.rate_bits,
            fri.cap_height,
            fri.proof_of_work_bits,
            fri.num_query_rounds,
            fri.arity_bits,
        )
    )
    buf.write(struct.pack("<2I", fri.final_poly_bits, common.degree_bits))
    gids = [g.gid for g in common.gates]
    blob = "\n".join(gids).encode()
    buf.write(struct.pack("<I", len(blob)))
    buf.write(blob)
    buf.write(struct.pack("<I", common.num_public_inputs))
    buf.write(struct.pack("<I", len(common.k_is)))
    buf.write(np.asarray(common.k_is, dtype="<u8").tobytes())
    buf.write(np.asarray(common.circuit_digest, dtype="<u8").tobytes())
    return buf.getvalue()


def common_from_bytes(data: bytes) -> CommonCircuitData:
    if data[:5] != MAGIC_COMMON:
        raise ValueError("Failed to deserialize common circuit data")
    off = 5
    vals = struct.unpack_from("<12I", data, off)
    off += 48
    final_poly_bits, degree_bits = struct.unpack_from("<2I", data, off)
    off += 8
    cfg = CircuitConfig(
        num_wires=vals[0],
        num_routed_wires=vals[1],
        num_constants=vals[2],
        security_bits=vals[3],
        num_challenges=vals[4],
        zero_knowledge=bool(vals[5]),
        max_quotient_degree_factor=vals[6],
        fri_config=FriConfig(
            rate_bits=vals[7],
            cap_height=vals[8],
            proof_of_work_bits=vals[9],
            num_query_rounds=vals[10],
            arity_bits=vals[11],
            final_poly_bits=final_poly_bits,
        ),
    )
    (blob_len,) = struct.unpack_from("<I", data, off)
    off += 4
    gids = data[off : off + blob_len].decode().split("\n") if blob_len else []
    off += blob_len
    (num_pis,) = struct.unpack_from("<I", data, off)
    off += 4
    (n_k,) = struct.unpack_from("<I", data, off)
    off += 4
    k_is = np.frombuffer(data, dtype="<u8", count=n_k, offset=off).astype(
        np.uint64
    )
    off += 8 * n_k
    digest = np.frombuffer(data, dtype="<u8", count=4, offset=off).astype(
        np.uint64
    )
    return CommonCircuitData(
        config=cfg,
        degree_bits=degree_bits,
        gates=[gate_from_gid(g) for g in gids],
        num_public_inputs=num_pis,
        k_is=k_is,
        circuit_digest=digest,
    )


def verifier_only_to_bytes(vd: VerifierOnlyCircuitData) -> bytes:
    buf = io.BytesIO()
    buf.write(MAGIC_VERIFIER)
    cap = np.asarray(vd.constants_sigmas_cap, dtype="<u8")
    buf.write(struct.pack("<I", cap.shape[0]))
    buf.write(cap.tobytes())
    buf.write(np.asarray(vd.circuit_digest, dtype="<u8").tobytes())
    return buf.getvalue()


def verifier_only_from_bytes(data: bytes) -> VerifierOnlyCircuitData:
    if data[:5] != MAGIC_VERIFIER:
        raise ValueError("Failed to deserialize verifier data from bytes")
    off = 5
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    cap = (
        np.frombuffer(data, dtype="<u8", count=n * 4, offset=off)
        .astype(np.uint64)
        .reshape(n, 4)
    )
    off += 8 * n * 4
    digest = np.frombuffer(data, dtype="<u8", count=4, offset=off).astype(
        np.uint64
    )
    return VerifierOnlyCircuitData(
        constants_sigmas_cap=cap, circuit_digest=digest
    )


def prover_only_to_bytes(pd: ProverOnlyCircuitData) -> bytes:
    return MAGIC_PROVER + pickle.dumps(pd, protocol=4)


def prover_only_from_bytes(data: bytes) -> ProverOnlyCircuitData:
    if data[:5] != MAGIC_PROVER:
        raise ValueError("Failed to deserialize prover only data")
    pd = pickle.loads(data[5:])
    if not isinstance(pd, ProverOnlyCircuitData):
        raise ValueError("Failed to deserialize prover only data")
    return pd


def circuit_data_to_bytes(data: CircuitData) -> bytes:
    """Whole-CircuitData round trip (reference circuit.rs:12-30)."""
    c = common_to_bytes(data.common)
    v = verifier_only_to_bytes(data.verifier_only)
    p = prover_only_to_bytes(data.prover_only)
    return (
        struct.pack("<3I", len(c), len(v), len(p)) + c + v + p
    )


def circuit_data_from_bytes(blob: bytes) -> CircuitData:
    lc, lv, lp = struct.unpack_from("<3I", blob, 0)
    off = 12
    common = common_from_bytes(blob[off : off + lc])
    off += lc
    verifier_only = verifier_only_from_bytes(blob[off : off + lv])
    off += lv
    prover_only = prover_only_from_bytes(blob[off : off + lp])
    return CircuitData(
        common=common, prover_only=prover_only, verifier_only=verifier_only
    )
