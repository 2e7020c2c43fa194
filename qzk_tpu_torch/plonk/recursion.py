"""Recursion: verify a proof INSIDE a circuit (the reference's
`add_virtual_proof_with_pis` / `verify_proof::<C>` /
`add_virtual_verifier_data` / `set_proof_with_pis_target` /
`set_verifier_data_target` surface — SURVEY.md §2b "Recursion gadgets",
call sites reference wormhole/aggregator/src/circuits/tree.rs:106-143).

A copy of the JAX package's qzk_tpu/plonk/recursion.py, statement for
statement: it builds circuits on the host and runs no device code, and
the order in which it emits gates is the circuit (a reordered fold or a
missed constant-folding case moves the circuit digest and every proof
byte after it), so the two packages build the same recursion circuits.
The witness fill is the exception: it sets the same targets to the same
values in the same order, with one array call a proof in place of one
call a value.

The in-circuit verifier mirrors plonk/verifier.py + plonk/fri.py
statement for statement:

  * transcript replay with an in-circuit Poseidon duplex challenger
    (RecursiveChallenger — same normative semantics as
    ops/transcript.py);
  * the vanishing identity at zeta re-uses the SAME eval_vanishing
    code as the host prover/verifier, instantiated over
    CircuitExtAlgebra, whose elements are constant-folded symbolic
    extension values lowered to arithmetic gates (the Poseidon gate's
    constraints take their generic branch over it, as over any algebra
    but gates.PyExtAlgebra);
  * the FRI verification (initial-oracle Merkle membership, batch
    combination, fold consistency, final-poly check, PoW) runs over
    index BITS (64-bit split of each query challenge), with Merkle
    path direction via the Poseidon gate's swap wire and cap lookup
    via select trees.

Everything here builds on the existing gate set only (arithmetic,
Poseidon, bit-decomposition) — no new gate types, so the recursive
circuit is provable/verifiable by the same engine it verifies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import goldilocks as gl
from ..ops import ntt as ntt_mod
from ..ops import poseidon as pos
from .builder import BoolTarget, CircuitBuilder, HashOutTarget
from .fri import _fold_matrices, _layer_cap_height
from .vanishing import eval_vanishing

# ---------------------------------------------------------------------------
# Symbolic extension values with constant folding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExtVal:
    """A quadratic-extension value inside the circuit.

    kind 'c': data = (int, int) — a compile-time constant;
    kind 'b': data = Target — a base-field target (imaginary part 0);
    kind 'x': data = (Target, Target).
    """

    kind: str
    data: tuple


def _c(v0: int, v1: int = 0) -> ExtVal:
    return ExtVal("c", (v0 % gl.P, v1 % gl.P))


class CircuitExtAlgebra:
    """The algebra interface of gates.py/vanishing.py, lowering to
    builder ops, with aggressive constant folding (Poseidon-gate
    constraint evaluation is dominated by constant MDS/RC terms)."""

    def __init__(self, builder: CircuitBuilder):
        self.b = builder

    # -- interface -----------------------------------------------------------

    def const(self, v: int) -> ExtVal:
        return _c(int(v))

    def lift(self, t) -> ExtVal:
        """A base-field TARGET used as a scalar.  NB: Targets are plain
        ints in this builder, so an int here is always a target — use
        `const` for compile-time constants."""
        if isinstance(t, ExtVal):
            return t
        return ExtVal("b", (t,))

    def from_targets(self, t0, t1) -> ExtVal:
        return ExtVal("x", (t0, t1))

    def zero(self) -> ExtVal:
        return _c(0)

    def one(self) -> ExtVal:
        return _c(1)

    # -- materialization -----------------------------------------------------

    def parts(self, a: ExtVal):
        """Lower to a pair of targets (materializes constants)."""
        b = self.b
        if a.kind == "c":
            return b.constant(a.data[0]), b.constant(a.data[1])
        if a.kind == "b":
            return a.data[0], b.zero()
        return a.data

    # -- ring ops -------------------------------------------------------------

    def add(self, a: ExtVal, b_: ExtVal) -> ExtVal:
        b = self.b
        if a.kind == "c" and b_.kind == "c":
            return _c(a.data[0] + b_.data[0], a.data[1] + b_.data[1])
        if a.kind == "c" and a.data == (0, 0):
            return b_
        if b_.kind == "c" and b_.data == (0, 0):
            return a
        if a.kind == "b" and b_.kind == "b":
            return ExtVal("b", (b.add(a.data[0], b_.data[0]),))
        if b_.kind == "c":
            a, b_ = b_, a
        if a.kind == "c":
            # const + (b|x)
            c0, c1 = a.data
            if b_.kind == "b":
                t0 = b.add_const(b_.data[0], c0)
                if c1 == 0:
                    return ExtVal("b", (t0,))
                return ExtVal("x", (t0, b.constant(c1)))
            t0 = b.add_const(b_.data[0], c0) if c0 else b_.data[0]
            t1 = b.add_const(b_.data[1], c1) if c1 else b_.data[1]
            return ExtVal("x", (t0, t1))
        a0, a1 = self.parts(a)
        b0, b1 = self.parts(b_)
        return ExtVal("x", (b.add(a0, b0), b.add(a1, b1)))

    def neg(self, a: ExtVal) -> ExtVal:
        b = self.b
        if a.kind == "c":
            return _c(-a.data[0], -a.data[1])
        if a.kind == "b":
            return ExtVal("b", (b.neg(a.data[0]),))
        return ExtVal("x", (b.neg(a.data[0]), b.neg(a.data[1])))

    def sub(self, a: ExtVal, b_: ExtVal) -> ExtVal:
        return self.add(a, self.neg(b_))

    def mul_const(self, c: int, x: ExtVal) -> ExtVal:
        return self.mul(self.const(c), x)

    def mul(self, a: ExtVal, b_: ExtVal) -> ExtVal:
        b = self.b
        if a.kind == "c" and b_.kind == "c":
            a0, a1 = a.data
            b0, b1 = b_.data
            return _c(a0 * b0 + 7 * a1 * b1, a0 * b1 + a1 * b0)
        if b_.kind == "c":
            a, b_ = b_, a
        if a.kind == "c":
            c0, c1 = a.data
            if (c0, c1) == (0, 0):
                return _c(0)
            if (c0, c1) == (1, 0):
                return b_
            if b_.kind == "b":
                t = b_.data[0]
                r0 = b.mul_const(c0, t)
                if c1 == 0:
                    return ExtVal("b", (r0,))
                return ExtVal("x", (r0, b.mul_const(c1, t)))
            t0, t1 = b_.data
            if c1 == 0:
                return ExtVal("x", (b.mul_const(c0, t0), b.mul_const(c0, t1)))
            # (c0 + c1 i)(t0 + t1 i) = c0 t0 + 7 c1 t1 + (c0 t1 + c1 t0) i
            r0 = b._arith_op(7 * c1 % gl.P, 1, t1, b.one(), b.mul_const(c0, t0))
            r1 = b._arith_op(c1, 1, t0, b.one(), b.mul_const(c0, t1))
            return ExtVal("x", (r0, r1))
        if a.kind == "b" and b_.kind == "b":
            return ExtVal("b", (b.mul(a.data[0], b_.data[0]),))
        if b_.kind == "b":
            a, b_ = b_, a
        if a.kind == "b":
            t = a.data[0]
            t0, t1 = b_.data
            return ExtVal("x", (b.mul(t, t0), b.mul(t, t1)))
        a0, a1 = a.data
        b0, b1 = b_.data
        # r0 = a0 b0 + 7 a1 b1 ; r1 = a0 b1 + a1 b0
        m = b.mul(a1, b1)
        r0 = b._arith_op(1, 7, a0, b0, m)  # a0*b0 + 7*(a1*b1)
        r1 = b.mul_add(a0, b1, b.mul(a1, b0))
        return ExtVal("x", (r0, r1))

    # -- extras used by the recursive verifier --------------------------------

    def inverse(self, a: ExtVal) -> ExtVal:
        """1/a for provably nonzero a (norm inverted via a witness)."""
        b = self.b
        a0, a1 = self.parts(a)
        # norm = a0^2 - 7 a1^2
        norm = b._arith_op(gl.P - 7, 1, a1, a1, b.mul(a0, a0))
        ninv = b.inverse(norm)
        return ExtVal("x", (b.mul(a0, ninv), b.neg(b.mul(a1, ninv))))

    def exp_u64(self, a: ExtVal, e: int) -> ExtVal:
        acc = self.one()
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            base = self.mul(base, base)
            e >>= 1
        return acc

    def select(self, bit: BoolTarget, x: ExtVal, y: ExtVal) -> ExtVal:
        b = self.b
        x0, x1 = self.parts(x)
        y0, y1 = self.parts(y)
        return ExtVal(
            "x", (b.select(bit, x0, y0), b.select(bit, x1, y1))
        )

    def connect(self, a: ExtVal, b_: ExtVal) -> None:
        b = self.b
        a0, a1 = self.parts(a)
        b0, b1 = self.parts(b_)
        b.connect(a0, b0)
        b.connect(a1, b1)


# Debug hook: when set to a list, checks are recorded as
# (label, targets_a, targets_b) instead of connected, so a witness run
# can report exactly which verification equations mismatch.
DEBUG_CHECKS: list | None = None


def _check_connect(builder, label: str, ts_a: list, ts_b: list) -> None:
    if DEBUG_CHECKS is not None:
        DEBUG_CHECKS.append((label, list(ts_a), list(ts_b)))
        return
    for a, b in zip(ts_a, ts_b):
        builder.connect(a, b)


# ---------------------------------------------------------------------------
# Base-field gadgets
# ---------------------------------------------------------------------------


def random_access(builder, bits, items):
    """items[sum bits_i 2^i] via a binary select tree.
    items: list of Targets, len == 2^len(bits); bits little-endian."""
    level = list(items)
    for bit in bits:
        nxt = []
        for i in range(0, len(level), 2):
            nxt.append(builder.select(bit, level[i + 1], level[i]))
        level = nxt
    assert len(level) == 1
    return level[0]


def random_access_digest(builder, bits, digests):
    return HashOutTarget.from_list(
        [
            random_access(builder, bits, [d.elements[i] for d in digests])
            for i in range(4)
        ]
    )


def exp_from_bits_const_base(builder, base: int, bits) -> "Target":
    """base^(sum bits_i 2^i) via selected-power products."""
    acc = builder.one()
    p = base % gl.P
    for bit in bits:
        acc = builder.mul(acc, builder.select(bit, builder.constant(p), builder.one()))
        p = p * p % gl.P
    return acc


# ---------------------------------------------------------------------------
# In-circuit challenger (duplex semantics of ops/transcript.py)
# ---------------------------------------------------------------------------


class RecursiveChallenger:
    def __init__(self, builder: CircuitBuilder):
        self.b = builder
        self.state = [builder.zero()] * pos.WIDTH
        self.input_buf: list = []
        self.output_buf: list = []

    def observe_element(self, t) -> None:
        self.output_buf.clear()
        self.input_buf.append(t)
        if len(self.input_buf) == pos.RATE:
            self._duplex()

    def observe_elements(self, ts) -> None:
        for t in ts:
            self.observe_element(t)

    def observe_cap(self, cap) -> None:
        for d in cap:
            self.observe_elements(d.elements)

    def observe_extension(self, x: ExtVal, alg: CircuitExtAlgebra) -> None:
        t0, t1 = alg.parts(x)
        self.observe_element(t0)
        self.observe_element(t1)

    def _duplex(self) -> None:
        k = len(self.input_buf)
        assert k <= pos.RATE
        state = list(self.state)
        if k:
            state[:k] = self.input_buf
            self.input_buf = []
        self.state = self.b.permute_poseidon(state)
        self.output_buf = list(self.state[: pos.RATE])

    def get_challenge(self):
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def get_n_challenges(self, n: int) -> list:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self, alg: CircuitExtAlgebra) -> ExtVal:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return alg.from_targets(c0, c1)


# ---------------------------------------------------------------------------
# Proof / verifier-data targets
# ---------------------------------------------------------------------------


@dataclass
class OpeningsTarget:
    preprocessed: list  # list[ExtVal 'x']
    wires: list
    zs_partial: list
    quotient: list
    zs_partial_right: list

    def batches(self):
        zeta_batch = (
            self.preprocessed + self.wires + self.zs_partial + self.quotient
        )
        return [("zeta", zeta_batch), ("g_zeta", self.zs_partial_right)]


@dataclass
class FriQueryStepTarget:
    leaf: list  # arity ExtVals ('x')
    path: list  # list[HashOutTarget]


@dataclass
class FriQueryRoundTarget:
    initial_leaves: list  # per oracle: list[Target]
    initial_paths: list  # per oracle: list[HashOutTarget]
    steps: list


@dataclass
class FriProofTarget:
    commit_phase_caps: list  # list[list[HashOutTarget]]
    final_poly: list  # list[ExtVal 'x']
    pow_witness: object  # Target
    query_rounds: list


@dataclass
class ProofWithPisTarget:
    wires_cap: list  # list[HashOutTarget]
    zs_partial_cap: list
    quotient_cap: list
    openings: OpeningsTarget
    fri: FriProofTarget
    public_inputs: list  # list[Target]

    def __getstate__(self):
        """The pickled state leaves out the target ids that the first
        fill derives and stores here (`_fill`), so that a chunk circuit
        pickles the same before and after a fill."""
        state = dict(self.__dict__)
        state.pop("_fill", None)
        return state


@dataclass
class VerifierCircuitTarget:
    constants_sigmas_cap: list  # list[HashOutTarget]
    circuit_digest: HashOutTarget


def _oracle_leaf_widths(common) -> list[int]:
    cfg = common.config
    salt = 4 if cfg.zero_knowledge else 0
    return [
        common.num_preprocessed_polys,
        cfg.num_wires + salt,
        common.num_zs_partial_products_polys + salt,
        common.num_quotient_polys + salt,
    ]


def add_virtual_proof_with_pis(
    builder: CircuitBuilder, common
) -> ProofWithPisTarget:
    """Allocate targets for a proof of a circuit with `common` data."""
    cfg = common.config
    fri_cfg = cfg.fri_config
    cap_n = 1 << fri_cfg.cap_height

    def vhashes(n):
        return [builder.add_virtual_hash() for _ in range(n)]

    def vexts(n):
        return [
            ExtVal("x", (builder.add_virtual_target(), builder.add_virtual_target()))
            for _ in range(n)
        ]

    openings = OpeningsTarget(
        preprocessed=vexts(common.num_preprocessed_polys),
        wires=vexts(cfg.num_wires),
        zs_partial=vexts(common.num_zs_partial_products_polys),
        quotient=vexts(common.num_quotient_polys),
        zs_partial_right=vexts(common.num_zs_partial_products_polys),
    )

    arities = common.fri_reduction_arity_bits
    lde_bits = common.lde_bits
    widths = _oracle_leaf_widths(common)
    init_depth = lde_bits - fri_cfg.cap_height

    commit_caps = []
    step_shapes = []  # (arity, depth, cap_height) per layer
    m = 1 << lde_bits
    for ab in arities:
        a = 1 << ab
        leaves = m // a
        ch = _layer_cap_height(fri_cfg, leaves)
        commit_caps.append(vhashes(1 << ch))
        step_shapes.append((a, leaves.bit_length() - 1 - ch, ch))
        m //= a

    rounds = []
    for _ in range(fri_cfg.num_query_rounds):
        init_leaves = [builder.add_virtual_targets(w) for w in widths]
        init_paths = [vhashes(init_depth) for _ in widths]
        steps = []
        for (a, depth, _ch) in step_shapes:
            steps.append(
                FriQueryStepTarget(leaf=vexts(a), path=vhashes(depth))
            )
        rounds.append(
            FriQueryRoundTarget(
                initial_leaves=init_leaves,
                initial_paths=init_paths,
                steps=steps,
            )
        )

    fri_t = FriProofTarget(
        commit_phase_caps=commit_caps,
        final_poly=vexts(common.final_poly_len),
        pow_witness=builder.add_virtual_target(),
        query_rounds=rounds,
    )
    return ProofWithPisTarget(
        wires_cap=vhashes(cap_n),
        zs_partial_cap=vhashes(cap_n),
        quotient_cap=vhashes(cap_n),
        openings=openings,
        fri=fri_t,
        public_inputs=builder.add_virtual_targets(common.num_public_inputs),
    )


def add_virtual_verifier_data(
    builder: CircuitBuilder, cap_height: int
) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(
        constants_sigmas_cap=[
            builder.add_virtual_hash() for _ in range(1 << cap_height)
        ],
        circuit_digest=builder.add_virtual_hash(),
    )


# ---------------------------------------------------------------------------
# In-circuit Merkle membership
# ---------------------------------------------------------------------------


def _leaf_digest(builder, leaf_targets) -> HashOutTarget:
    if len(leaf_targets) <= 4:
        padded = list(leaf_targets) + [builder.zero()] * (4 - len(leaf_targets))
        return HashOutTarget.from_list(padded)
    return builder.hash_n_to_hash_no_pad(list(leaf_targets))


def verify_merkle_proof_circuit(
    builder,
    leaf_targets,
    index_bits,  # lsb-first BoolTargets; len == depth + cap_height
    path,  # list[HashOutTarget], len == depth
    cap,  # list[HashOutTarget], len == 2^cap_height
) -> None:
    h = _leaf_digest(builder, leaf_targets)
    for d, sib in enumerate(path):
        bit = index_bits[d]
        state = (
            list(h.elements)
            + list(sib.elements)
            + [builder.zero()] * 4
        )
        out = builder.permute_poseidon(state, swap=bit)
        h = HashOutTarget.from_list(out[:4])
    cap_bits = index_bits[len(path) :]
    expected = random_access_digest(builder, cap_bits, cap)
    _check_connect(
        builder, "merkle-cap", list(h.elements), list(expected.elements)
    )


# ---------------------------------------------------------------------------
# The full in-circuit verifier
# ---------------------------------------------------------------------------


def verify_proof_circuit(
    builder: CircuitBuilder,
    proof_t: ProofWithPisTarget,
    verifier_data_t: VerifierCircuitTarget,
    common,
) -> None:
    """Constrain `proof_t` to be a valid proof for the circuit described
    by (`common`, `verifier_data_t`).  Mirrors plonk/verifier.py."""
    alg = CircuitExtAlgebra(builder)
    cfg = common.config
    fri_cfg = cfg.fri_config
    N = common.degree

    pi_hash = builder.hash_n_to_hash_no_pad(list(proof_t.public_inputs))

    # -- transcript replay ----------------------------------------------------
    ch = RecursiveChallenger(builder)
    ch.observe_elements(verifier_data_t.circuit_digest.elements)
    ch.observe_elements(pi_hash.elements)
    ch.observe_cap(proof_t.wires_cap)
    betas = ch.get_n_challenges(cfg.num_challenges)
    gammas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(proof_t.zs_partial_cap)
    alphas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(proof_t.quotient_cap)
    zeta = ch.get_extension_challenge(alg)
    o = proof_t.openings
    for _tag, vals in o.batches():
        for v in vals:
            ch.observe_extension(v, alg)
    fri_alpha = ch.get_extension_challenge(alg)

    # -- vanishing identity at zeta --------------------------------------------
    n_sel = common.num_selectors
    n_const = cfg.num_constants
    zpp = common.num_partial_products

    zs, zs_right, partials = [], [], []
    for c in range(cfg.num_challenges):
        base = c * (1 + zpp)
        zs.append(o.zs_partial[base])
        zs_right.append(o.zs_partial_right[base])
        partials.append([o.zs_partial[base + 1 + k] for k in range(zpp)])

    zeta_pow_n = alg.exp_u64(zeta, N)
    z_h = alg.sub(zeta_pow_n, alg.one())
    denom = alg.mul(alg.const(N), alg.sub(zeta, alg.one()))
    l1 = alg.mul(z_h, alg.inverse(denom))

    vanishing = eval_vanishing(
        common,
        alg,
        zeta,
        o.wires,
        o.preprocessed[:n_sel],
        o.preprocessed[n_sel : n_sel + n_const],
        o.preprocessed[n_sel + n_const :],
        zs,
        zs_right,
        partials,
        [alg.lift(t) for t in pi_hash.elements],
        betas,
        gammas,
        alphas,
        l1,
    )

    for c in range(cfg.num_challenges):
        acc = alg.zero()
        for t in reversed(range(cfg.max_quotient_degree_factor)):
            acc = alg.mul(acc, zeta_pow_n)
            acc = alg.add(acc, o.quotient[c * cfg.max_quotient_degree_factor + t])
        expected = alg.mul(z_h, acc)
        _check_connect(
            builder,
            f"vanishing-{c}",
            list(alg.parts(vanishing[c])),
            list(alg.parts(expected)),
        )

    # -- FRI ---------------------------------------------------------------------
    S = common.num_preprocessed_polys
    n_wires = cfg.num_wires
    n_zs = common.num_zs_partial_products_polys
    n_q = common.num_quotient_polys
    salt = 4 if cfg.zero_knowledge else 0
    w_pre = S
    w_wires = n_wires + salt
    w_zs = n_zs + salt
    off_wires = w_pre
    off_zs = off_wires + w_wires
    off_quot = off_zs + w_zs

    def zeta_cols(leaves):
        # leaves: per-oracle lists of targets, concatenated layout
        flat = []
        flat.extend(leaves[0][:S])
        flat.extend(leaves[1][:n_wires])
        flat.extend(leaves[2][:n_zs])
        flat.extend(leaves[3][:n_q])
        return flat

    def gzeta_cols(leaves):
        return list(leaves[2][:n_zs])

    def reduce_claims(claims):
        acc = alg.zero()
        for v in claims[::-1]:
            acc = alg.mul(acc, fri_alpha)
            acc = alg.add(acc, v)
        return acc

    zeta_claims = o.preprocessed + o.wires + o.zs_partial + o.quotient
    g = common.subgroup_generator()
    zeta_right = alg.mul(zeta, alg.const(g))
    reduced_zeta = reduce_claims(zeta_claims)
    reduced_right = reduce_claims(o.zs_partial_right)

    caps = [
        verifier_data_t.constants_sigmas_cap,
        proof_t.wires_cap,
        proof_t.zs_partial_cap,
        proof_t.quotient_cap,
    ]

    fri_verify_circuit(
        builder,
        alg,
        ch,
        caps,
        [
            (zeta, reduced_zeta, zeta_cols),
            (zeta_right, reduced_right, gzeta_cols),
        ],
        proof_t.fri,
        common,
        fri_alpha,
    )


def _split_64(builder, t):
    """64 little-endian bits of a target (mod-p representation chosen by
    the witness; the honest prover uses the canonical one — same
    semantics the reference engine's recursive FRI uses for query
    indices)."""
    return builder.split_le(t, 64)


def fri_verify_circuit(
    builder,
    alg: CircuitExtAlgebra,
    ch: RecursiveChallenger,
    caps,
    batch_spec,  # [(z ExtVal, reduced_claim ExtVal, col_fn)]
    fri_t: FriProofTarget,
    common,
    fri_alpha: ExtVal,
) -> None:
    cfg = common.config.fri_config
    degree_bits = common.degree_bits
    arities = common.fri_reduction_arity_bits
    lde_bits = common.lde_bits
    M0 = 1 << lde_bits

    # transcript: layer caps -> betas; final poly; PoW; query indices
    betas = []
    for cap in fri_t.commit_phase_caps:
        ch.observe_cap(cap)
        betas.append(ch.get_extension_challenge(alg))
    for c in fri_t.final_poly:
        ch.observe_extension(c, alg)
    # PoW: top `proof_of_work_bits` bits of the response must be zero
    ch.observe_element(fri_t.pow_witness)
    pow_response = ch.get_challenge()
    pow_bits = _split_64(builder, pow_response)
    _check_connect(
        builder,
        "pow",
        [b.target for b in pow_bits[64 - cfg.proof_of_work_bits :]],
        [builder.zero()] * cfg.proof_of_work_bits,
    )

    w0 = ntt_mod.root_of_unity(lde_bits)

    for q in range(cfg.num_query_rounds):
        round_t = fri_t.query_rounds[q]
        idx_t = ch.get_challenge()
        idx_bits = _split_64(builder, idx_t)[:lde_bits]

        # 1. initial oracle membership
        for o_i, cap in enumerate(caps):
            verify_merkle_proof_circuit(
                builder,
                round_t.initial_leaves[o_i],
                idx_bits,
                round_t.initial_paths[o_i],
                cap,
            )

        # 2. evaluate G at x0
        x0 = builder.mul(
            builder.constant(gl.GENERATOR),
            exp_from_bits_const_base(builder, w0, idx_bits),
        )
        x0_ext = alg.lift(x0)
        value = alg.zero()
        for (z, reduced_claim, col_fn) in batch_spec:
            cols = col_fn(round_t.initial_leaves)
            comb = alg.zero()
            for t in cols[::-1]:
                comb = alg.mul(comb, fri_alpha)
                comb = alg.add(comb, alg.lift(t))
            num = alg.sub(comb, reduced_claim)
            den = alg.sub(x0_ext, z)
            value = alg.add(value, alg.mul(num, alg.inverse(den)))

        # 3. fold through layers
        bits = idx_bits  # bits of j within the current domain (size M)
        M = M0
        shift = gl.GENERATOR
        x = x0_ext
        for t_i, (ab, beta) in enumerate(zip(arities, betas)):
            A = 1 << ab
            group_bits = (M // A).bit_length() - 1  # bits of jg
            jg_bits = bits[:group_bits]
            k_bits = bits[group_bits : group_bits + ab]
            step = fri_t.query_rounds[q].steps[t_i]

            # leaf[k_in_group] == value  (random access over the coset)
            got0 = random_access(
                builder, k_bits, [alg.parts(v)[0] for v in step.leaf]
            )
            got1 = random_access(
                builder, k_bits, [alg.parts(v)[1] for v in step.leaf]
            )
            v0, v1 = alg.parts(value)
            _check_connect(
                builder, f"fold-consistency-q{q}-l{t_i}", [got0, got1], [v0, v1]
            )

            # membership of the coset leaf in this layer's tree
            flat_leaf = []
            for v in step.leaf:
                p0, p1 = alg.parts(v)
                flat_leaf.extend((p0, p1))
            verify_merkle_proof_circuit(
                builder, flat_leaf, jg_bits, step.path, fri_t.commit_phase_caps[t_i]
            )

            # s_j = shift * w0^{jg * M0/M}
            sj = builder.mul(
                builder.constant(shift),
                exp_from_bits_const_base(
                    builder, pow(w0, M0 // M, gl.P), jg_bits
                ),
            )
            sj_inv = builder.inverse(sj)

            # coset iNTT fold: value' = sum_t beta^t s_j^{-t} sum_k leaf_k W[k,t]
            W = _fold_matrices(ab)
            c_t = []
            for t in range(A):
                acc = alg.zero()
                for k in range(A):
                    acc = alg.add(
                        acc, alg.mul(alg.const(int(W[k][t])), step.leaf[k])
                    )
                c_t.append(acc)
            sj_inv_e = alg.lift(sj_inv)
            out = alg.zero()
            scale = alg.mul(beta, sj_inv_e)
            for t in reversed(range(A)):
                out = alg.mul(out, scale)
                out = alg.add(out, c_t[t])
            value = out

            bits = jg_bits
            M //= A
            shift = pow(shift, A, gl.P)
            for _ in range(ab):
                x = alg.mul(x, x)

        # 4. final polynomial evaluation
        fp = alg.zero()
        for c in fri_t.final_poly[::-1]:
            fp = alg.mul(fp, x)
            fp = alg.add(fp, c)
        _check_connect(
            builder,
            f"fri-final-q{q}",
            list(alg.parts(fp)),
            list(alg.parts(value)),
        )


# ---------------------------------------------------------------------------
# Witness fill (PartialWitness setters)
# ---------------------------------------------------------------------------


def _fill_targets(proof_t: ProofWithPisTarget):
    """(ids, sizes): the proof's targets in the order the fill sets them
    (caps, openings as extension pairs, FRI layer caps, final polynomial,
    PoW witness, then each query's initial leaves and paths and its
    steps' leaves and paths, then the public inputs), and the length of
    each part.  Fixed by the circuit, so kept on `proof_t`."""
    cached = proof_t.__dict__.get("_fill")
    if cached is not None:
        return cached
    parts = []

    def caps(cap_ts):
        parts.append([t for d in cap_ts for t in d.elements])

    def exts(ext_ts):
        assert all(e.kind == "x" for e in ext_ts)
        parts.append([t for e in ext_ts for t in e.data])

    caps(proof_t.wires_cap)
    caps(proof_t.zs_partial_cap)
    caps(proof_t.quotient_cap)
    ot = proof_t.openings
    for ext_ts in (ot.preprocessed, ot.wires, ot.zs_partial, ot.quotient, ot.zs_partial_right):
        exts(ext_ts)
    ft = proof_t.fri
    for cap_t in ft.commit_phase_caps:
        caps(cap_t)
    exts(ft.final_poly)
    parts.append([ft.pow_witness])
    for rt in ft.query_rounds:
        parts.extend(list(leaf_ts) for leaf_ts in rt.initial_leaves)
        for path_ts in rt.initial_paths:
            caps(path_ts)
        for st in rt.steps:
            exts(st.leaf)
            caps(st.path)
    parts.append(list(proof_t.public_inputs))
    ids = np.fromiter((t for part in parts for t in part), dtype=np.int64)
    proof_t._fill = (ids, [len(part) for part in parts])
    return proof_t._fill


def _fill_values(pwpi) -> list:
    """The proof's values as flat uint64 arrays, part by part as
    _fill_targets lists the targets."""
    p = pwpi.proof
    o = p.openings
    f = p.fri
    parts = [p.wires_cap, p.zs_partial_cap, p.quotient_cap, o.preprocessed, o.wires,
             o.zs_partial, o.quotient, o.zs_partial_right, *f.commit_phase_caps,
             f.final_poly, [f.pow_witness]]
    for r in f.query_rounds:
        parts.extend(r.initial.leaves)
        parts.extend(r.initial.paths)
        for s in r.steps:
            parts.extend((s.leaf, s.path))
    parts.append(pwpi.public_inputs)
    return [np.asarray(v, dtype=np.uint64).reshape(-1) for v in parts]


def set_proof_with_pis_target(pw, proof_t: ProofWithPisTarget, pwpi) -> None:
    """Fill proof targets from a concrete ProofWithPublicInputs, with one
    set_target_arr call over every target of the proof."""
    ids, sizes = _fill_targets(proof_t)
    vals = _fill_values(pwpi)
    if [len(v) for v in vals] != sizes:
        raise ValueError("the proof's shape is not its proof targets'")
    pw.set_target_arr(ids, np.concatenate(vals))


def set_verifier_data_target(pw, vd_t: VerifierCircuitTarget, verifier_only) -> None:
    """One set_target_arr call: the constants/sigmas cap, then the
    circuit digest."""
    digests = [*vd_t.constants_sigmas_cap, vd_t.circuit_digest]
    cap = np.asarray(verifier_only.constants_sigmas_cap, dtype=np.uint64).reshape(-1, 4)
    digest = np.asarray(verifier_only.circuit_digest, dtype=np.uint64).reshape(4)
    if len(cap) != len(vd_t.constants_sigmas_cap):
        raise ValueError("the verifier data's cap is not its target's size")
    pw.set_target_arr([t for d in digests for t in d.elements], np.concatenate([cap.ravel(), digest]))
