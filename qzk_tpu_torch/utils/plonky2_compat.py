"""Readers for the reference engine's serialized artifacts (qp-plonky2
v1.1.1 byte formats), reverse-engineered from the checked-in fixtures:

    reference wormhole/bench-data/common.bin    (1,045 B)
    reference wormhole/bench-data/verifier.bin  (1,597 B)
    reference wormhole/bench-data/proof.bin     (148,932 B)
    reference wormhole/aggregator/data/dummy_proof{,_zk}.bin

These are REAL Rust-made artifacts (CommonCircuitData::to_bytes with
DefaultGateSerializer, VerifierOnlyCircuitData::to_bytes,
ProofWithPublicInputs::to_bytes — written by the reference's export
tests, tests/src/prover/prover_tests.rs:56-120).  Parsing them — and
verifying proof.bin end-to-end with this framework's own transcript /
FRI machinery (plonky2_verify.py) — is the strongest cross-validation
available without a Rust toolchain: it checks our Poseidon, challenger,
Merkle hashing, FRI fold arithmetic and PLONK constraint semantics
against an independent implementation at the bit level.

Byte format (little-endian throughout; `usize` is 8 bytes):

CommonCircuitData:
    CircuitConfig:
        num_wires u64, num_routed_wires u64, num_constants u64,
        security_bits u64, num_challenges u64,
        max_quotient_degree_factor u64,
        use_base_arithmetic_gate u8, zero_knowledge u8,
        FriConfig:
            rate_bits u64, cap_height u64, num_query_rounds u64,
            proof_of_work_bits u32,
            reduction_strategy: tag u8 (1 = ConstantArityBits)
                + arity_bits u64 + final_poly_bits u64
    FriParams:
        FriConfig (again), reduction_arity_bits (len u64 + u64*len),
        degree_bits u64, hiding u8
    selectors_info: selector_indices (len u64 + u64*len),
        groups (len u64 + (start u64, end u64)*len)
    quotient_degree_factor u64, num_gate_constraints u64,
    num_constants u64, num_public_inputs u64,
    k_is (len u64 + u64*len),
    num_partial_products u64, num_lookup_polys u64,
    num_lookup_selectors u64, luts (len u64, assumed 0),
    gates (len u64 + per gate: u32 tag + params)

DefaultGateSerializer tags observed (tag -> params):
    0  ArithmeticGate        num_ops u64
    2  BaseSumGate<2>        num_limbs u64
    3  ConstantGate          num_consts u64
    9  NoopGate              -
    11 PoseidonGate          -
    12 PublicInputGate       -

VerifierOnlyCircuitData:
    constants_sigmas_cap (len u64 + 32 B per hash), circuit_digest 32 B
(the bench-data verifier.bin is VerifierCircuitData = verifier_only
followed by CommonCircuitData).

ProofWithPublicInputs: see read_proof().

This module is the JAX package's qzk_tpu/utils/plonky2_compat.py on the
port, statement for statement: host code, numpy only.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


class Plonky2FormatError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def u64s(self, n: int) -> np.ndarray:
        out = np.frombuffer(
            self.data, dtype="<u8", count=n, offset=self.pos
        ).astype(np.uint64)
        self.pos += 8 * n
        return out

    def vec_u64(self) -> np.ndarray:
        return self.u64s(self.u64())

    def done(self) -> bool:
        return self.pos == len(self.data)


@dataclass
class P2FriConfig:
    rate_bits: int
    cap_height: int
    num_query_rounds: int
    proof_of_work_bits: int
    arity_bits: int
    final_poly_bits: int


@dataclass
class P2CircuitConfig:
    num_wires: int
    num_routed_wires: int
    num_config_constants: int
    security_bits: int
    num_challenges: int
    max_quotient_degree_factor: int
    use_base_arithmetic_gate: bool
    zero_knowledge: bool
    fri: P2FriConfig


@dataclass
class P2Gate:
    """A parsed gate: DefaultGateSerializer tag + params."""

    tag: int
    params: tuple = ()

    NAMES = {
        0: "ArithmeticGate",
        2: "BaseSumGate<2>",
        3: "ConstantGate",
        9: "NoopGate",
        11: "PoseidonGate",
        12: "PublicInputGate",
    }

    @property
    def name(self) -> str:
        base = self.NAMES.get(self.tag, f"UnknownGate#{self.tag}")
        if self.params:
            return f"{base}{list(self.params)}"
        return base


@dataclass
class P2CommonData:
    config: P2CircuitConfig
    reduction_arity_bits: list
    degree_bits: int
    hiding: bool
    selector_indices: list
    selector_groups: list  # [(start, end)]
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: np.ndarray
    num_partial_products: int
    num_lookup_polys: int
    num_lookup_selectors: int
    gates: list  # [P2Gate]

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.fri.rate_bits

    @property
    def num_selectors(self) -> int:
        return len(self.selector_groups)

    @property
    def num_preprocessed(self) -> int:
        """Columns of the constants_sigmas oracle (no salt — public
        oracle).  num_constants already counts the selector polynomials:
        constant polys [0:num_selectors] ARE the selectors, the rest are
        gate constants (verified against proof.bin's oracle width 84 =
        4 + 80)."""
        return self.num_constants + self.config.num_routed_wires

    @property
    def num_zs_partial(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    @property
    def num_quotient(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    @property
    def salt_size(self) -> int:
        return 4 if self.config.zero_knowledge else 0


def _read_fri_config(r: _Reader) -> P2FriConfig:
    rate_bits = r.u64()
    cap_height = r.u64()
    num_query_rounds = r.u64()
    pow_bits = r.u32()
    tag = r.u8()
    if tag != 1:
        raise Plonky2FormatError(
            f"unsupported FriReductionStrategy tag {tag}"
        )
    arity_bits = r.u64()
    final_poly_bits = r.u64()
    return P2FriConfig(
        rate_bits=rate_bits,
        cap_height=cap_height,
        num_query_rounds=num_query_rounds,
        proof_of_work_bits=pow_bits,
        arity_bits=arity_bits,
        final_poly_bits=final_poly_bits,
    )


def _read_circuit_config(r: _Reader) -> P2CircuitConfig:
    return P2CircuitConfig(
        num_wires=r.u64(),
        num_routed_wires=r.u64(),
        num_config_constants=r.u64(),
        security_bits=r.u64(),
        num_challenges=r.u64(),
        max_quotient_degree_factor=r.u64(),
        use_base_arithmetic_gate=bool(r.u8()),
        zero_knowledge=bool(r.u8()),
        fri=_read_fri_config(r),
    )


_GATE_PARAM_COUNT = {0: 1, 2: 1, 3: 1, 9: 0, 11: 0, 12: 0}


def read_common(data: bytes) -> P2CommonData:
    r = _Reader(data)
    config = _read_circuit_config(r)
    _read_fri_config(r)  # FriParams.config duplicates the FriConfig
    arities = [int(x) for x in r.vec_u64()]
    degree_bits = r.u64()
    hiding = bool(r.u8())
    selector_indices = [int(x) for x in r.vec_u64()]
    n_groups = r.u64()
    groups = [(r.u64(), r.u64()) for _ in range(n_groups)]
    qdf = r.u64()
    ngc = r.u64()
    n_consts = r.u64()
    n_pis = r.u64()
    k_is = r.vec_u64()
    npp = r.u64()
    nlp = r.u64()
    nls = r.u64()
    n_luts = r.u64()
    if n_luts:
        raise Plonky2FormatError("lookup tables not supported")
    n_gates = r.u64()
    gates = []
    for _ in range(n_gates):
        tag = r.u32()
        if tag not in _GATE_PARAM_COUNT:
            raise Plonky2FormatError(f"unknown gate tag {tag}")
        params = tuple(r.u64() for _ in range(_GATE_PARAM_COUNT[tag]))
        gates.append(P2Gate(tag=tag, params=params))
    if not r.done():
        raise Plonky2FormatError(
            f"{len(data) - r.pos} trailing bytes after common data"
        )
    return P2CommonData(
        config=config,
        reduction_arity_bits=arities,
        degree_bits=degree_bits,
        hiding=hiding,
        selector_indices=selector_indices,
        selector_groups=groups,
        quotient_degree_factor=qdf,
        num_gate_constraints=ngc,
        num_constants=n_consts,
        num_public_inputs=n_pis,
        k_is=k_is,
        num_partial_products=npp,
        num_lookup_polys=nlp,
        num_lookup_selectors=nls,
        gates=gates,
    )


@dataclass
class P2VerifierOnly:
    constants_sigmas_cap: np.ndarray  # (cap, 4)
    circuit_digest: np.ndarray  # (4,)


def read_verifier_only(data: bytes) -> "P2VerifierOnly | tuple":
    """Parse a VerifierOnlyCircuitData blob.  The bench-data
    verifier.bin is the full VerifierCircuitData (verifier_only then
    common); in that case returns (P2VerifierOnly, P2CommonData)."""
    r = _Reader(data)
    cap_height = r.u64()  # leading usize is the cap HEIGHT, not length
    n_cap = 1 << cap_height
    cap = r.u64s(n_cap * 4).reshape(n_cap, 4)
    digest = r.u64s(4)
    vo = P2VerifierOnly(constants_sigmas_cap=cap, circuit_digest=digest)
    if r.done():
        return vo
    common = read_common(data[r.pos :])
    return vo, common


@dataclass
class P2Openings:
    """plonky2 OpeningSet in its native vector layout.  `constants`
    covers the selector polynomials (constant polys [0:num_selectors]
    are the selectors)."""

    constants: np.ndarray  # (num_constants, 2)
    sigmas: np.ndarray  # (num_routed, 2)
    wires: np.ndarray  # (num_wires, 2)
    zs: np.ndarray  # (num_challenges, 2)   Z_c(zeta)
    zs_next: np.ndarray  # (num_challenges, 2)   Z_c(g*zeta)
    partial_products: np.ndarray  # (num_challenges*npp, 2) grouped by c
    quotient: np.ndarray  # (num_quotient, 2)

    def fri_batches(self):
        """(values at zeta, values at g*zeta) in plonky2's
        to_fri_openings order."""
        zeta = np.concatenate(
            [
                self.constants,
                self.sigmas,
                self.wires,
                self.zs,
                self.partial_products,
                self.quotient,
            ]
        )
        return zeta, self.zs_next


@dataclass
class P2QueryRound:
    initial_leaves: list  # per oracle: (w,) uint64 evals (bit-rev index)
    initial_paths: list  # per oracle: list[(4,) digest]
    step_evals: list  # per layer: (arity, 2) ext evals (bit-rev order)
    step_paths: list  # per layer: list[(4,) digest]


@dataclass
class P2FriProof:
    commit_phase_caps: list
    query_rounds: list  # [P2QueryRound]
    final_poly: np.ndarray  # (final_len, 2)
    pow_witness: int


@dataclass
class P2Proof:
    wires_cap: np.ndarray
    zs_partial_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: P2Openings
    fri: P2FriProof
    public_inputs: np.ndarray


def read_proof(data: bytes, common: P2CommonData) -> P2Proof:
    """Parse a ProofWithPublicInputs blob (plonky2 byte layout):

        write_proof: wires_cap, zs_partial_products_cap, quotient_cap,
            openings(constants, sigmas, wires, zs, zs_next,
                     partial_products, quotient), fri_proof
        fri_proof: commit_phase caps, query rounds, final_poly coeffs,
            pow_witness
        query round: per oracle (evals vec + merkle proof), then per
            reduction step (ext evals vec + merkle proof); merkle proof
            = siblings len u8 + 32 B per sibling
        then write_usize(num_public_inputs) + the public inputs.

    All Merkle-tree leaf indices (initial oracles and commit-phase
    trees) are in plonky2's bit-reversed point order; step eval vectors
    are bit-reversed within the coset.
    """
    cfg = common.config
    r = _Reader(data)
    cap_n = 1 << cfg.fri.cap_height

    def read_cap():
        return r.u64s(cap_n * 4).reshape(cap_n, 4)

    def read_ext_vec(n):
        return r.u64s(n * 2).reshape(n, 2)

    def read_merkle_proof():
        n = r.u8()
        return [r.u64s(4) for _ in range(n)]

    wires_cap = read_cap()
    zs_cap = read_cap()
    quot_cap = read_cap()

    nc = cfg.num_challenges
    npp = common.num_partial_products
    openings = P2Openings(
        constants=read_ext_vec(common.num_constants),
        sigmas=read_ext_vec(cfg.num_routed_wires),
        wires=read_ext_vec(cfg.num_wires),
        zs=read_ext_vec(nc),
        zs_next=read_ext_vec(nc),
        partial_products=read_ext_vec(nc * npp),
        quotient=read_ext_vec(common.num_quotient),
    )

    n_layers = len(common.reduction_arity_bits)
    phase_caps = [read_cap() for _ in range(n_layers)]
    salt = common.salt_size
    oracle_widths = [
        common.num_preprocessed,  # public oracle: never salted
        cfg.num_wires + salt,
        common.num_zs_partial + salt,
        common.num_quotient + salt,
    ]
    rounds = []
    for _ in range(cfg.fri.num_query_rounds):
        leaves, paths = [], []
        for w in oracle_widths:
            leaves.append(r.u64s(w))
            paths.append(read_merkle_proof())
        step_evals, step_paths = [], []
        for ab in common.reduction_arity_bits:
            step_evals.append(read_ext_vec(1 << ab))
            step_paths.append(read_merkle_proof())
        rounds.append(
            P2QueryRound(
                initial_leaves=leaves,
                initial_paths=paths,
                step_evals=step_evals,
                step_paths=step_paths,
            )
        )
    final_len = 1 << (
        common.degree_bits - sum(common.reduction_arity_bits)
    )
    final_poly = read_ext_vec(final_len)
    pow_witness = int(r.u64())
    n_pis = r.u64()  # public-input vector is length-prefixed
    if n_pis != common.num_public_inputs:
        raise Plonky2FormatError(
            f"public-input count mismatch: {n_pis} vs common "
            f"{common.num_public_inputs}"
        )
    public_inputs = r.u64s(n_pis)
    if not r.done():
        raise Plonky2FormatError(
            f"{len(data) - r.pos} trailing bytes after proof"
        )
    return P2Proof(
        wires_cap=wires_cap,
        zs_partial_cap=zs_cap,
        quotient_cap=quot_cap,
        openings=openings,
        fri=P2FriProof(
            commit_phase_caps=phase_caps,
            query_rounds=rounds,
            final_poly=final_poly,
            pow_witness=pow_witness,
        ),
        public_inputs=public_inputs,
    )
