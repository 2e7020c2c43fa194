"""Readers of the circuit's key bytes (the common data, magic QZKC\\x01,
and the verifier-only data, magic QZKV\\x01) and of the proof bytes, in
plain Python and numpy.  Each refuses bytes that do not have exactly the
shape the key describes."""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass

import numpy as np

from . import field as F


class FormatError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise FormatError("bytes end early")
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def words(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.take(8 * n), dtype="<u8").astype(np.uint64)
        if (out >= F._P).any():
            raise FormatError("a word is not a canonical field element")
        return out

    def done(self) -> None:
        if self.off != len(self.data):
            raise FormatError(f"{len(self.data) - self.off} bytes left over")


@dataclass
class Common:
    num_wires: int
    num_routed_wires: int
    num_constants: int
    num_challenges: int
    zero_knowledge: bool
    quotient_degree_factor: int
    rate_bits: int
    cap_height: int
    pow_bits: int
    num_queries: int
    arity_bits: int
    final_poly_bits: int
    degree_bits: int
    gates: list  # gate ids, in selector order
    num_public_inputs: int
    k_is: list
    circuit_digest: np.ndarray

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.rate_bits

    @property
    def num_preprocessed(self) -> int:
        return len(self.gates) + self.num_constants + self.num_routed_wires

    @property
    def chunk_size(self) -> int:
        return self.quotient_degree_factor - 1

    @property
    def num_chunks(self) -> int:
        return -(-self.num_routed_wires // self.chunk_size)

    @property
    def num_zs(self) -> int:
        return self.num_challenges * self.num_chunks

    @property
    def num_quotient(self) -> int:
        return self.num_challenges * self.quotient_degree_factor

    @property
    def salt(self) -> int:
        return 4 if self.zero_knowledge else 0

    def arities(self) -> list:
        """The FRI fold schedule: folds of arity_bits until at most
        2^final_poly_bits coefficients are left."""
        out, d = [], self.degree_bits
        while d > self.final_poly_bits:
            step = min(self.arity_bits, d - self.final_poly_bits)
            out.append(step)
            d -= step
        return out


_GATE = re.compile(r"arithmetic<\d+>|poseidon<12>|bit_decomp<\d+,\d+>|constant<\d+>"
                   r"|public_input|noop")


def read_common(data: bytes) -> Common:
    r = _Reader(data)
    if r.take(5) != b"QZKC\x01":
        raise FormatError("not common circuit data")
    v = struct.unpack("<12I", r.take(48))
    final_poly_bits, degree_bits = struct.unpack("<2I", r.take(8))
    blob = r.take(r.u32()).decode()
    gates = blob.split("\n") if blob else []
    for g in gates:
        if not _GATE.fullmatch(g):
            raise FormatError(f"unknown gate {g!r}")
    num_pis = r.u32()
    k_is = [int(k) for k in r.words(r.u32())]
    digest = r.words(4)
    r.done()
    return Common(
        num_wires=v[0], num_routed_wires=v[1], num_constants=v[2], num_challenges=v[4],
        zero_knowledge=bool(v[5]), quotient_degree_factor=v[6], rate_bits=v[7],
        cap_height=v[8], pow_bits=v[9], num_queries=v[10], arity_bits=v[11],
        final_poly_bits=final_poly_bits, degree_bits=degree_bits, gates=gates,
        num_public_inputs=num_pis, k_is=k_is, circuit_digest=digest)


@dataclass
class VerifierKey:
    constants_sigmas_cap: np.ndarray  # (2^cap_height, 4)
    circuit_digest: np.ndarray  # (4,)


def read_verifier(data: bytes) -> VerifierKey:
    r = _Reader(data)
    if r.take(5) != b"QZKV\x01":
        raise FormatError("not verifier-only data")
    n = r.u32()
    cap = r.words(4 * n).reshape(n, 4)
    digest = r.words(4)
    r.done()
    return VerifierKey(cap, digest)


@dataclass
class Proof:
    public_inputs: np.ndarray
    caps: list  # wires, zs and partial products, quotient: (2^h, 4) each
    openings: dict  # preprocessed, wires, zs, quotient, zs_right: (n, 2)
    layer_caps: list
    final_poly: np.ndarray  # (n, 2)
    pow_witness: int
    leaves: list  # per oracle, (Q, width)
    paths: list  # per oracle, (Q, depth, 4)
    step_leaves: list  # per FRI layer, (Q, arity, 2)
    step_paths: list  # per FRI layer, (Q, depth, 4)


def read_proof(data: bytes, c: Common) -> Proof:
    """The proof bytes, held to the shapes `c` prescribes."""
    r = _Reader(data)
    pis = r.words(c.num_public_inputs)
    cap_n = 1 << min(c.cap_height, c.lde_bits)
    caps = [r.words(4 * cap_n).reshape(cap_n, 4) for _ in range(3)]
    widths = {"preprocessed": c.num_preprocessed, "wires": c.num_wires, "zs": c.num_zs,
              "quotient": c.num_quotient, "zs_right": c.num_zs}
    openings = {k: r.words(2 * n).reshape(n, 2) for k, n in widths.items()}
    arities = c.arities()
    if r.u32() != len(arities):
        raise FormatError("wrong number of FRI layers")
    layer_caps, leaves_left = [], c.lde_bits
    for ab in arities:
        leaves_left -= ab
        n = r.u32()
        if n != 1 << min(c.cap_height, leaves_left):
            raise FormatError("wrong FRI layer cap size")
        layer_caps.append(r.words(4 * n).reshape(n, 4))
    fp_len = r.u32()
    if fp_len != 1 << (c.degree_bits - sum(arities)):
        raise FormatError("wrong final polynomial length")
    final_poly = r.words(2 * fp_len).reshape(fp_len, 2)
    pow_witness = struct.unpack("<Q", r.take(8))[0]
    if r.u32() != c.num_queries:
        raise FormatError("wrong number of query rounds")
    oracle_widths = [c.num_preprocessed, c.num_wires + c.salt, c.num_zs + c.salt,
                     c.num_quotient + c.salt]
    depth0 = c.lde_bits - min(c.cap_height, c.lde_bits)
    leaves = [[] for _ in oracle_widths]
    paths = [[] for _ in oracle_widths]
    step_leaves = [[] for _ in arities]
    step_paths = [[] for _ in arities]
    for _ in range(c.num_queries):
        if r.u32() != len(oracle_widths):
            raise FormatError("wrong number of oracles")
        for o, w in enumerate(oracle_widths):
            if r.u32() != w:
                raise FormatError("wrong leaf width")
            leaves[o].append(r.words(w))
            if r.u32() != depth0:
                raise FormatError("wrong Merkle path depth")
            paths[o].append(r.words(4 * depth0).reshape(depth0, 4))
        if r.u32() != len(arities):
            raise FormatError("wrong number of FRI steps")
        bits = c.lde_bits
        for t, ab in enumerate(arities):
            if r.u32() != 1 << ab:
                raise FormatError("wrong FRI arity")
            step_leaves[t].append(r.words(2 << ab).reshape(1 << ab, 2))
            bits -= ab
            depth = bits - min(c.cap_height, bits)
            if r.u32() != depth:
                raise FormatError("wrong FRI path depth")
            step_paths[t].append(r.words(4 * depth).reshape(depth, 4))
    r.done()
    return Proof(
        public_inputs=pis, caps=caps, openings=openings, layer_caps=layer_caps,
        final_poly=final_poly, pow_witness=pow_witness,
        leaves=[np.stack(x) for x in leaves], paths=[np.stack(x) for x in paths],
        step_leaves=[np.stack(x) for x in step_leaves],
        step_paths=[np.stack(x) for x in step_paths])
