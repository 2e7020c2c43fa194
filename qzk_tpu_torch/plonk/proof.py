"""Proof structures + binary serialization.

Layout parity with the reference's ProofWithPublicInputs surface
(wires/zs/quotient caps, openings, FRI commit-phase caps, final
polynomial, PoW witness, query rounds — SURVEY.md §2b "Prove pipeline").
Serialization is this stack's own deterministic little-endian format
(semantic-compat: the reference's byte format is private to its
non-vendored engine)."""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class FriInitialProof:
    """Per-oracle opening at one query index."""

    leaves: list  # list of (w,) uint64 arrays, one per oracle
    paths: list  # list of list[(4,) digest]


@dataclass
class FriQueryStep:
    leaf: np.ndarray  # (arity, 2) extension values of the coset
    path: list  # merkle siblings


@dataclass
class FriQueryRound:
    initial: FriInitialProof
    steps: list  # list[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_caps: list  # list of (2^h, 4) caps
    final_poly: np.ndarray  # (final_len, 2) extension coeffs
    pow_witness: int
    query_rounds: list  # list[FriQueryRound]


@dataclass
class Openings:
    """Claimed evaluations at zeta (and g*zeta for the Z/partial columns)."""

    preprocessed: np.ndarray  # (S, 2)
    wires: np.ndarray  # (135, 2)
    zs_partial: np.ndarray  # (24, 2)
    quotient: np.ndarray  # (16, 2)
    zs_partial_right: np.ndarray  # (24, 2) at g*zeta

    def batches(self):
        """(point_tag, stacked values) in the normative FRI batch order."""
        zeta_batch = np.concatenate(
            [self.preprocessed, self.wires, self.zs_partial, self.quotient]
        )
        return [("zeta", zeta_batch), ("g_zeta", self.zs_partial_right)]


@dataclass
class Proof:
    wires_cap: np.ndarray
    zs_partial_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: Openings
    fri: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: np.ndarray  # (num_pis,) uint64

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        w = _Writer()
        p = self.proof
        w.u64s(self.public_inputs)
        for cap in (p.wires_cap, p.zs_partial_cap, p.quotient_cap):
            w.u64s(cap.ravel())
        o = p.openings
        for arr in (
            o.preprocessed,
            o.wires,
            o.zs_partial,
            o.quotient,
            o.zs_partial_right,
        ):
            w.u64s(arr.ravel())
        w.u32(len(p.fri.commit_phase_caps))
        for cap in p.fri.commit_phase_caps:
            w.u32(cap.shape[0])
            w.u64s(cap.ravel())
        w.u32(p.fri.final_poly.shape[0])
        w.u64s(p.fri.final_poly.ravel())
        w.u64(p.fri.pow_witness)
        w.u32(len(p.fri.query_rounds))
        for q in p.fri.query_rounds:
            w.u32(len(q.initial.leaves))
            for leaf, path in zip(q.initial.leaves, q.initial.paths):
                w.u32(leaf.shape[0])
                w.u64s(leaf)
                w.u32(len(path))
                for sib in path:
                    w.u64s(sib)
            w.u32(len(q.steps))
            for s in q.steps:
                w.u32(s.leaf.shape[0])
                w.u64s(s.leaf.ravel())
                w.u32(len(s.path))
                for sib in s.path:
                    w.u64s(sib)
        return w.getvalue()

    @staticmethod
    def from_bytes(data: bytes, common) -> "ProofWithPublicInputs":
        r = _Reader(data)
        pis = r.u64s(common.num_public_inputs)
        cap_n = 1 << min(
            common.config.fri_config.cap_height, common.lde_bits
        )
        caps = [r.u64s(cap_n * 4).reshape(cap_n, 4) for _ in range(3)]
        S = common.num_preprocessed_polys
        openings = Openings(
            preprocessed=r.u64s(S * 2).reshape(S, 2),
            wires=r.u64s(common.config.num_wires * 2).reshape(-1, 2),
            zs_partial=r.u64s(
                common.num_zs_partial_products_polys * 2
            ).reshape(-1, 2),
            quotient=r.u64s(common.num_quotient_polys * 2).reshape(-1, 2),
            zs_partial_right=r.u64s(
                common.num_zs_partial_products_polys * 2
            ).reshape(-1, 2),
        )
        n_layers = r.u32()
        phase_caps = []
        for _ in range(n_layers):
            n = r.u32()
            phase_caps.append(r.u64s(n * 4).reshape(n, 4))
        fp_len = r.u32()
        final_poly = r.u64s(fp_len * 2).reshape(fp_len, 2)
        pow_witness = int(r.u64())
        n_queries = r.u32()
        rounds = []
        for _ in range(n_queries):
            n_oracles = r.u32()
            leaves, paths = [], []
            for _ in range(n_oracles):
                lw = r.u32()
                leaves.append(r.u64s(lw))
                pl = r.u32()
                paths.append([r.u64s(4) for _ in range(pl)])
            n_steps = r.u32()
            steps = []
            for _ in range(n_steps):
                arity = r.u32()
                leaf = r.u64s(arity * 2).reshape(arity, 2)
                pl = r.u32()
                path = [r.u64s(4) for _ in range(pl)]
                steps.append(FriQueryStep(leaf=leaf, path=path))
            rounds.append(
                FriQueryRound(
                    initial=FriInitialProof(leaves=leaves, paths=paths),
                    steps=steps,
                )
            )
        proof = Proof(
            wires_cap=caps[0],
            zs_partial_cap=caps[1],
            quotient_cap=caps[2],
            openings=openings,
            fri=FriProof(
                commit_phase_caps=phase_caps,
                final_poly=final_poly,
                pow_witness=pow_witness,
                query_rounds=rounds,
            ),
        )
        return ProofWithPublicInputs(proof=proof, public_inputs=pis)


class _Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", int(v)))

    def u64(self, v: int):
        self.buf.write(struct.pack("<Q", int(v)))

    def u64s(self, arr):
        self.buf.write(
            np.ascontiguousarray(np.asarray(arr, dtype="<u8")).tobytes()
        )

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.off)
        self.off += 8
        return v

    def u64s(self, n: int) -> np.ndarray:
        out = np.frombuffer(
            self.data, dtype="<u8", count=n, offset=self.off
        ).astype(np.uint64)
        self.off += 8 * n
        return out
