"""CircuitBuilder — plonky2-semantic circuit description layer.

Reproduces the builder surface the reference circuits consume
(SURVEY.md §1 L1->L2/L3 interface: add_virtual_target,
add_virtual_hash(_public_input), hash_n_to_hash_no_pad, range_check,
connect, connect_hashes, select, is_equal, split_le, constants, build /
build_prover / build_verifier), lowering to the vectorized gate set in
gates.py.  Copy constraints use a union-find over targets; witness
computation is recorded as a generator list that the prover executes in
levelized batches (creation order is topological by construction).

Row packing mirrors plonky2's slot reuse: arithmetic ops with equal
(c0, c1) share rows (20 ops/row), bit decompositions pack
80 // (bits+1) ops/row, constants 2/row.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon as pos
from .config import CircuitConfig
from .gates import (
    ArithmeticGate,
    BitDecompGate,
    ConstantGate,
    NoopGate,
    PoseidonGate,
    PublicInputGate,
)

Target = int


@dataclass(frozen=True)
class BoolTarget:
    target: Target


@dataclass(frozen=True)
class HashOutTarget:
    elements: tuple  # 4 targets

    @staticmethod
    def from_list(ts):
        assert len(ts) == 4
        return HashOutTarget(elements=tuple(ts))


@dataclass
class GateInstance:
    gate: object
    constants: list  # length num_constants, python ints


@dataclass
class Generator:
    kind: str
    data: tuple


class CircuitBuilder:
    def __init__(self, config: CircuitConfig | None = None):
        self.config = config or CircuitConfig.standard_recursion_config()
        self.rows: list[GateInstance] = []
        self.slot_target: dict[tuple[int, int], Target] = {}
        self.generators: list[Generator] = []
        self.public_inputs: list[Target] = []
        self._num_targets = 0
        self._parent: list[int] = []  # union-find
        # open-row slot tracking
        self._open_arith: dict[tuple[int, int], tuple[int, int]] = {}
        self._open_bits: dict[int, tuple[int, int]] = {}
        self._open_const: tuple[int, int] | None = None
        self._constant_cache: dict[int, Target] = {}
        self._built = False

    # -- targets & union-find ----------------------------------------------

    def add_virtual_target(self) -> Target:
        t = self._num_targets
        self._num_targets += 1
        self._parent.append(t)
        return t

    def add_virtual_targets(self, n: int) -> list[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self) -> HashOutTarget:
        return HashOutTarget.from_list(self.add_virtual_targets(4))

    def add_virtual_bool_target_safe(self) -> BoolTarget:
        t = self.add_virtual_target()
        b = BoolTarget(t)
        self.assert_bool(b)  # t * t == t
        return b

    def add_virtual_bool_target_unsafe(self) -> BoolTarget:
        return BoolTarget(self.add_virtual_target())

    def _find(self, t: Target) -> Target:
        root = t
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[t] != root:
            self._parent[t], t = root, self._parent[t]
        return root

    def connect(self, a: Target, b: Target) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[ra] = rb

    def connect_hashes(self, a: HashOutTarget, b: HashOutTarget) -> None:
        for x, y in zip(a.elements, b.elements):
            self.connect(x, y)

    # -- public inputs ------------------------------------------------------

    def register_public_input(self, t: Target) -> None:
        self.public_inputs.append(t)

    def register_public_inputs(self, ts) -> None:
        for t in ts:
            self.register_public_input(t)

    def add_virtual_public_input(self) -> Target:
        t = self.add_virtual_target()
        self.register_public_input(t)
        return t

    def add_virtual_hash_public_input(self) -> HashOutTarget:
        h = self.add_virtual_hash()
        self.register_public_inputs(h.elements)
        return h

    # -- row/slot plumbing --------------------------------------------------

    def _new_row(self, gate, constants=None) -> int:
        row = len(self.rows)
        nc = self.config.num_constants
        consts = list(constants or [])
        consts += [0] * (nc - len(consts))
        self.rows.append(GateInstance(gate=gate, constants=consts))
        return row

    def _bind(self, row: int, col: int, t: Target) -> None:
        key = (row, col)
        existing = self.slot_target.get(key)
        if existing is None:
            self.slot_target[key] = t
        else:
            self.connect(existing, t)

    # -- constants ----------------------------------------------------------

    def constant(self, value: int) -> Target:
        value = int(value) % gl.P
        if value in self._constant_cache:
            return self._constant_cache[value]
        if self._open_const is None or self._open_const[1] >= 2:
            row = self._new_row(ConstantGate(), [value, 0])
            idx = 0
            self._open_const = (row, 1)
        else:
            row, idx = self._open_const
            self.rows[row].constants[idx] = value
            self._open_const = (row, idx + 1)
        t = self.add_virtual_target()
        self._bind(row, idx, t)
        self.generators.append(Generator("const", (t, value)))
        self._constant_cache[value] = t
        return t

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    def two(self) -> Target:
        return self.constant(2)

    def _false(self) -> BoolTarget:
        return BoolTarget(self.zero())

    def _true(self) -> BoolTarget:
        return BoolTarget(self.one())

    def constant_bool(self, b: bool) -> BoolTarget:
        return BoolTarget(self.one() if b else self.zero())

    # -- arithmetic ---------------------------------------------------------

    def _arith_op(
        self,
        c0: int,
        c1: int,
        m0: Target,
        m1: Target,
        addend: Target,
        existing_out: Target | None = None,
        connect_to: Target | None = None,
    ) -> Target:
        """Allocate one op computing out = c0*m0*m1 + c1*addend."""
        c0 %= gl.P
        c1 %= gl.P
        key = (c0, c1)
        gate = ArithmeticGate()
        slot = self._open_arith.get(key)
        if slot is None or slot[1] >= gate.num_ops:
            row = self._new_row(gate, [c0, c1])
            op = 0
        else:
            row, op = slot
        self._open_arith[key] = (row, op + 1)
        w_m0, w_m1, w_a, w_out = gate.wires_op(op)
        self._bind(row, w_m0, m0)
        self._bind(row, w_m1, m1)
        self._bind(row, w_a, addend)
        if connect_to is not None:
            out = connect_to
        elif existing_out is not None:
            out = existing_out
        else:
            out = self.add_virtual_target()
        self._bind(row, w_out, out)
        if connect_to is None:
            self.generators.append(
                Generator("arith", (c0, c1, m0, m1, addend, out))
            )
        return out

    def add(self, a: Target, b: Target) -> Target:
        # out = 1*a*ONE + 1*b  -> use mul form: c0*a*b with b=one
        return self._arith_op(1, 1, a, self.one(), b)

    def sub(self, a: Target, b: Target) -> Target:
        # out = 1*a*ONE + (p-1)*b
        return self._arith_op(1, gl.P - 1, a, self.one(), b)

    def mul(self, a: Target, b: Target) -> Target:
        return self._arith_op(1, 0, a, b, self.zero())

    def mul_const(self, c: int, a: Target) -> Target:
        return self._arith_op(int(c) % gl.P, 0, a, self.one(), self.zero())

    def add_const(self, a: Target, c: int) -> Target:
        return self._arith_op(1, 1, a, self.one(), self.constant(c))

    def mul_add(self, a: Target, b: Target, c: Target) -> Target:
        """a*b + c."""
        return self._arith_op(1, 1, a, b, c)

    def neg(self, a: Target) -> Target:
        return self.mul_const(gl.P - 1, a)

    # -- boolean logic ------------------------------------------------------

    def not_(self, b: BoolTarget) -> BoolTarget:
        # 1 - b = (p-1)*b*one + 1*one
        return BoolTarget(
            self._arith_op(gl.P - 1, 1, b.target, self.one(), self.one())
        )

    def and_(self, a: BoolTarget, b: BoolTarget) -> BoolTarget:
        return BoolTarget(self.mul(a.target, b.target))

    def or_(self, a: BoolTarget, b: BoolTarget) -> BoolTarget:
        # a + b - ab = -(a*b) + (a+b)
        s = self.add(a.target, b.target)
        return BoolTarget(self._arith_op(gl.P - 1, 1, a.target, b.target, s))

    def select(self, b: BoolTarget, x: Target, y: Target) -> Target:
        """b ? x : y  ==  b*(x-y) + y."""
        d = self.sub(x, y)
        return self._arith_op(1, 1, b.target, d, y)

    def is_equal(self, x: Target, y: Target) -> BoolTarget:
        """eq = 1 iff x == y, via an inverse-or-zero witness hint."""
        diff = self.sub(x, y)
        inv = self.add_virtual_target()  # filled with diff^-1 (or 0)
        self.generators.append(Generator("inv_or_zero", (diff, inv)))
        # eq = 1 - diff*inv
        eq = self._arith_op(gl.P - 1, 1, diff, inv, self.one())
        # diff * eq == 0
        self._arith_op(1, 0, diff, eq, self.zero(), connect_to=self.zero())
        # eq boolean: eq*eq == eq
        self._arith_op(1, 0, eq, eq, self.zero(), connect_to=eq)
        return BoolTarget(eq)

    # -- bit decomposition --------------------------------------------------

    def split_le(self, t: Target, bits: int) -> list[BoolTarget]:
        """Decompose into `bits` little-endian bits (constrains t < 2^bits).

        bits == 64 admits two representations of small values (v and
        v + p both fit in 64 bits when v < 2^32 - 1); used only where
        that ambiguity is sound (FRI query indices / PoW response —
        see recursion.py)."""
        assert 1 <= bits <= 64
        gate = BitDecompGate(
            bits=bits, num_ops=max(1, self.config.num_routed_wires // (bits + 1))
        )
        slot = self._open_bits.get(bits)
        if slot is None or slot[1] >= gate.num_ops:
            row = self._new_row(gate)
            op = 0
        else:
            row, op = slot
        self._open_bits[bits] = (row, op + 1)
        v_w, bit_ws = gate.wires_op(op)
        self._bind(row, v_w, t)
        bit_ts = self.add_virtual_targets(bits)
        for w, bt in zip(bit_ws, bit_ts):
            self._bind(row, w, bt)
        self.generators.append(Generator("bits", (t, tuple(bit_ts))))
        return [BoolTarget(b) for b in bit_ts]

    def range_check(self, t: Target, bits: int) -> None:
        self.split_le(t, bits)

    def inverse(self, x: Target) -> Target:
        """1/x as a witness, constrained by x * inv == 1 (so x == 0 is
        unprovable)."""
        inv = self.add_virtual_target()
        self.generators.append(Generator("inv_or_zero", (x, inv)))
        self._arith_op(1, 0, x, inv, self.zero(), connect_to=self.one())
        return inv

    def assert_bool(self, b: BoolTarget) -> None:
        self._arith_op(
            1, 0, b.target, b.target, self.zero(), connect_to=b.target
        )

    def assert_zero(self, t: Target) -> None:
        self.connect(t, self.zero())

    def assert_one(self, t: Target) -> None:
        self.connect(t, self.one())

    # -- hashing ------------------------------------------------------------

    def permute_poseidon(
        self, inputs: list[Target], swap: BoolTarget | None = None
    ) -> list[Target]:
        """One PoseidonGate row permuting 12 inputs; returns 12 outputs."""
        assert len(inputs) == 12
        gate = PoseidonGate()
        row = self._new_row(gate)
        swap_t = swap.target if swap is not None else self.zero()
        self._bind(row, gate.WIRE_SWAP, swap_t)
        for i, t in enumerate(inputs):
            self._bind(row, gate.wire_in(i), t)
        outs = self.add_virtual_targets(12)
        for i, t in enumerate(outs):
            self._bind(row, gate.wire_out(i), t)
        internal = {}
        for i in range(4):
            internal[gate.wire_delta(i)] = self.add_virtual_target()
        for r in range(1, 4):
            for i in range(12):
                internal[gate.wire_full0(r, i)] = self.add_virtual_target()
        for pr in range(pos.N_PARTIAL_ROUNDS):
            internal[gate.wire_partial(pr)] = self.add_virtual_target()
        for r in range(4):
            for i in range(12):
                internal[gate.wire_full1(r, i)] = self.add_virtual_target()
        for w, t in internal.items():
            self._bind(row, w, t)
        self.generators.append(
            Generator(
                "poseidon",
                (tuple(inputs), swap_t, tuple(internal.items()), tuple(outs)),
            )
        )
        return outs

    def hash_n_to_hash_no_pad(self, inputs: list[Target]) -> HashOutTarget:
        """In-circuit PoseidonHash::hash_no_pad (overwrite-mode sponge)."""
        inputs = list(inputs)
        state = [self.zero()] * 12
        for start in range(0, len(inputs), pos.RATE):
            chunk = inputs[start : start + pos.RATE]
            state = list(state)
            state[: len(chunk)] = chunk
            state = self.permute_poseidon(state)
        return HashOutTarget.from_list(state[:4])

    def hash_or_noop(self, inputs: list[Target]) -> HashOutTarget:
        if len(inputs) <= 4:
            padded = list(inputs) + [self.zero()] * (4 - len(inputs))
            return HashOutTarget.from_list(padded)
        return self.hash_n_to_hash_no_pad(inputs)

    # -- build --------------------------------------------------------------

    def build(self):
        from .circuit_data import build_circuit_data

        return build_circuit_data(self)

    def build_prover(self):
        return self.build().prover_data()

    def build_verifier(self):
        return self.build().verifier_data()
