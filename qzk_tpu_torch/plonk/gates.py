"""Gate set for the PLONK engine.

Semantic parity with the plonky2 gate surface the reference circuits use
(SURVEY.md §2b row 5: arithmetic, Poseidon, range-check / split_le via
bit decomposition, constants, public-input registration), re-designed
for vectorized evaluation: every gate's constraints are written once
against a tiny algebra abstraction and evaluated either

  * on the whole LDE coset at once (base field, numpy vectors — the
    prover's quotient computation), or
  * at the single challenge point zeta (quadratic extension — the
    verifier), or
  * on the device (torch int64 tensors) for the device prover.

Gate selectors are boolean per-type columns; constraint degrees
(including the selector factor) stay <= max_quotient_degree_factor = 8.

Wire layouts:
  ArithmeticGate  : 20 ops x (m0, m1, addend, out); out = c0*m0*m1 + c1*addend
  PoseidonGate    : 135 wires — 12 in, 12 out, swap, 4 deltas, 36 + 22 + 48
                    stored sbox inputs (degree-7 round constraints)
  BitDecompGate(b): ops x (value, b bits); value = sum b_i 2^i, bits boolean
  ConstantGate    : wires 0..2 pinned to the row's constant column values
  PublicInputGate : wires 0..4 pinned to H(public_inputs)
  NoopGate        : padding
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon as pos
from ..utils.device import device_constant


def _wire_index(gate, name: str, idx, device):
    """A gate's wire-index vector on `device`, uploaded once."""
    import torch

    return device_constant((gate, name), device,
                           lambda: torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                                   device=device))

# ---------------------------------------------------------------------------
# Evaluation algebras
# ---------------------------------------------------------------------------


class BaseAlgebra:
    """Base-field vectors (coset evaluation). Elements: uint64 ndarrays
    broadcastable against each other."""

    def const(self, v: int):
        return np.uint64(v % gl.P)

    add = staticmethod(gl.add)
    sub = staticmethod(gl.sub)
    mul = staticmethod(gl.mul)

    def mul_const(self, c: int, x):
        """Multiply by a small non-negative python-int constant."""
        return gl.mul(np.uint64(c % gl.P), x)

    def zero(self):
        return np.uint64(0)

    def one(self):
        return np.uint64(1)

    def lift(self, v):
        """A scalar challenge (int/uint64) used as an algebra element."""
        return self.const(int(v))


class ExtAlgebra:
    """Quadratic-extension scalars (opening evaluation). Elements:
    (..., 2) uint64 ndarrays."""

    def const(self, v: int):
        return np.array([v % gl.P, 0], dtype=np.uint64)

    add = staticmethod(gl.ext_add)
    sub = staticmethod(gl.ext_sub)
    mul = staticmethod(gl.ext_mul)

    def mul_const(self, c: int, x):
        return gl.ext_scalar_mul(np.uint64(c % gl.P), x)

    def zero(self):
        return np.zeros(2, dtype=np.uint64)

    def one(self):
        return np.array([1, 0], dtype=np.uint64)

    def lift(self, v):
        return self.const(int(v))


class PyExtAlgebra:
    """Quadratic-extension scalars as python-int pairs (c0, c1).

    Same semantics as ExtAlgebra (x^2 = 7) but ~20x faster for the
    verifier's single-point vanishing evaluation: the ~30k field ops of
    the gate-constraint walk cost microseconds each as native ints vs
    numpy-scalar dispatch overhead.  Convert at the boundary with
    to_pair/from_pair."""

    P = gl.P

    @staticmethod
    def to_pair(a) -> tuple:
        a = np.asarray(a, dtype=np.uint64)
        return (int(a[0]), int(a[1]))

    @staticmethod
    def from_pair(t) -> np.ndarray:
        return np.array([t[0] % gl.P, t[1] % gl.P], dtype=np.uint64)

    def const(self, v: int):
        return (v % gl.P, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % gl.P, (a[1] + b[1]) % gl.P)

    def sub(self, a, b):
        return ((a[0] - b[0]) % gl.P, (a[1] - b[1]) % gl.P)

    def mul(self, a, b):
        a0, a1 = a
        b0, b1 = b
        return (
            (a0 * b0 + 7 * a1 * b1) % gl.P,
            (a0 * b1 + a1 * b0) % gl.P,
        )

    def mul_const(self, c: int, x):
        c %= gl.P
        return (c * x[0] % gl.P, c * x[1] % gl.P)

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def lift(self, v):
        return self.const(int(v))


class TorchAlgebra:
    """Device base-field vectors (torch int64 bit patterns) for the
    coset evaluation of gates without an eval_constraints_torch."""

    def __init__(self, device):
        from ..ops import goldilocks_cuda as gt

        self._gt = gt
        self.device = device

    def const(self, v: int):
        v %= gl.P
        return device_constant(("field", v), self.device,
                               lambda: self._gt.scalar(v, self.device))

    def add(self, a, b):
        return self._gt.add(a, b)

    def sub(self, a, b):
        return self._gt.sub(a, b)

    def mul(self, a, b):
        return self._gt.mul(a, b)

    def mul_const(self, c: int, x):
        if 0 <= c < (1 << 32):
            return self._gt.mul_small(x, c)
        return self._gt.mul(self.const(c), x)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def lift(self, v):
        if isinstance(v, (int, np.integer)):
            return self.const(int(v))
        return v  # a 0-d device tensor (challenges stay on the device)


def _x7(alg, x):
    x2 = alg.mul(x, x)
    x3 = alg.mul(x2, x)
    x4 = alg.mul(x2, x2)
    return alg.mul(x4, x3)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Gate:
    """Base gate descriptor.  Subclasses define wire layout constants and
    `eval_constraints(alg, wires, consts, pi_hash) -> list`."""

    def eval_constraints(self, alg, wires, consts, pi_hash):
        raise NotImplementedError

    @property
    def gid(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class ArithmeticGate(Gate):
    num_ops: int = 20

    @property
    def gid(self):
        return f"arithmetic<{self.num_ops}>"

    def wires_op(self, i: int):
        return (4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3)

    def eval_constraints(self, alg, wires, consts, pi_hash):
        c0, c1 = consts[0], consts[1]
        out = []
        for i in range(self.num_ops):
            m0, m1, a, o = (wires[w] for w in self.wires_op(i))
            computed = alg.add(alg.mul(c0, alg.mul(m0, m1)), alg.mul(c1, a))
            out.append(alg.sub(computed, o))
        return out

    def eval_constraints_torch(self, wires_mat, const_mat, pi_hash):
        """Stacked device evaluation: (num_cons, M) rows in the same
        order as eval_constraints."""
        from ..ops import goldilocks_cuda as gt

        idx = np.array(
            [self.wires_op(i) for i in range(self.num_ops)], dtype=np.int64
        )
        m0, m1, a, o = (
            wires_mat[_wire_index(self, f"op{k}", idx[:, k], wires_mat.device)]
            for k in range(4)
        )
        c0, c1 = const_mat[0][None, :], const_mat[1][None, :]
        return gt.sub(
            gt.add(gt.mul(c0, gt.mul(m0, m1)), gt.mul(c1, a)), o
        )


@dataclass(frozen=True)
class PoseidonGate(Gate):
    """One full Poseidon permutation per row (width 12), with merkle-path
    swap support.  135 wires exactly."""

    WIDTH = 12

    @property
    def gid(self):
        return "poseidon<12>"

    # -- wire layout --------------------------------------------------------
    def wire_in(self, i):
        return i

    def wire_out(self, i):
        return 12 + i

    WIRE_SWAP = 24

    def wire_delta(self, i):
        return 25 + i  # i in 0..4

    def wire_full0(self, r, i):
        # first-half full rounds 1..3 store their sbox inputs
        assert 1 <= r < 4
        return 29 + (r - 1) * 12 + i

    def wire_partial(self, pr):
        assert 0 <= pr < pos.N_PARTIAL_ROUNDS
        return 65 + pr

    def wire_full1(self, r, i):
        assert 0 <= r < 4
        return 87 + r * 12 + i

    NUM_WIRES = 135

    def eval_constraints(self, alg, wires, consts, pi_hash):
        if isinstance(alg, PyExtAlgebra):
            # this gate is ~2/3 of the verifier's single-point
            # constraint walk; the deferred-mod int path below is
            # value-identical and ~5x faster than the generic algebra
            return self._eval_constraints_pyint(wires)
        W = self.WIDTH
        RC = pos._RC  # (30, 12) uint64
        MDS = pos.MDS_MATRIX  # (12, 12) small ints

        def mds(state):
            out = []
            for r in range(W):
                acc = alg.zero()
                for c in range(W):
                    acc = alg.add(
                        acc, alg.mul_const(int(MDS[r][c]), state[c])
                    )
                out.append(acc)
            return out

        cons = []
        swap = wires[self.WIRE_SWAP]
        # swap is boolean
        cons.append(alg.sub(alg.mul(swap, swap), swap))
        # delta_i = swap * (in[i+4] - in[i])
        deltas = [wires[self.wire_delta(i)] for i in range(4)]
        for i in range(4):
            want = alg.mul(
                swap, alg.sub(wires[self.wire_in(i + 4)], wires[self.wire_in(i)])
            )
            cons.append(alg.sub(deltas[i], want))
        # initial state with swap applied
        state = []
        for i in range(4):
            state.append(alg.add(wires[self.wire_in(i)], deltas[i]))
        for i in range(4):
            state.append(alg.sub(wires[self.wire_in(i + 4)], deltas[i]))
        for i in range(8, W):
            state.append(wires[self.wire_in(i)])

        rc = lambda r: [alg.const(int(RC[r][i])) for i in range(W)]

        # round 0 (full): sbox inputs are linear — not stored
        pre = [alg.add(state[i], rc(0)[i]) for i in range(W)]
        state = mds([_x7(alg, x) for x in pre])
        # full rounds 1..3: stored sbox inputs
        for r in range(1, 4):
            pre = [alg.add(state[i], rc(r)[i]) for i in range(W)]
            stored = [wires[self.wire_full0(r, i)] for i in range(W)]
            cons.extend(alg.sub(stored[i], pre[i]) for i in range(W))
            state = mds([_x7(alg, x) for x in stored])
        # partial rounds: store lane-0 sbox input only
        for pr in range(pos.N_PARTIAL_ROUNDS):
            r = 4 + pr
            pre = [alg.add(state[i], rc(r)[i]) for i in range(W)]
            stored = wires[self.wire_partial(pr)]
            cons.append(alg.sub(stored, pre[0]))
            state = mds([_x7(alg, stored)] + pre[1:])
        # second-half full rounds: all stored
        for r in range(4):
            rr = 4 + pos.N_PARTIAL_ROUNDS + r
            pre = [alg.add(state[i], rc(rr)[i]) for i in range(W)]
            stored = [wires[self.wire_full1(r, i)] for i in range(W)]
            cons.extend(alg.sub(stored[i], pre[i]) for i in range(W))
            state = mds([_x7(alg, x) for x in stored])
        # outputs
        cons.extend(
            alg.sub(wires[self.wire_out(i)], state[i]) for i in range(W)
        )
        return cons

    _PYINT_TABLES = None

    @classmethod
    def _pyint_tables(cls):
        if cls._PYINT_TABLES is None:
            cls._PYINT_TABLES = (
                [[int(v) for v in row] for row in pos.MDS_MATRIX],
                [[int(v) for v in row] for row in pos._RC],
            )
        return cls._PYINT_TABLES

    def _eval_constraints_pyint(self, wires):
        """PyExtAlgebra twin of eval_constraints: same constraint list,
        same values mod P, plain python-int pairs with the MDS row sums
        reduced once per component instead of per term (144 -> 2 mods
        per row)."""
        W = self.WIDTH
        P = gl.P
        MDS, RC = self._pyint_tables()

        def mds(state):
            out = []
            for row in MDS:
                acc0 = 0
                acc1 = 0
                for m, s in zip(row, state):
                    acc0 += m * s[0]
                    acc1 += m * s[1]
                out.append((acc0 % P, acc1 % P))
            return out

        def x7(x):
            a0, a1 = x
            b0 = (a0 * a0 + 7 * a1 * a1) % P  # x^2
            b1 = 2 * a0 * a1 % P
            c0 = (b0 * a0 + 7 * b1 * a1) % P  # x^3
            c1 = (b0 * a1 + b1 * a0) % P
            d0 = (b0 * b0 + 7 * b1 * b1) % P  # x^4
            d1 = 2 * b0 * b1 % P
            return ((d0 * c0 + 7 * d1 * c1) % P, (d0 * c1 + d1 * c0) % P)

        cons = []
        s0, s1 = wires[self.WIRE_SWAP]
        cons.append(
            ((s0 * s0 + 7 * s1 * s1 - s0) % P, (2 * s0 * s1 - s1) % P)
        )
        deltas = [wires[self.wire_delta(i)] for i in range(4)]
        for i in range(4):
            x0, x1 = wires[self.wire_in(i + 4)]
            y0, y1 = wires[self.wire_in(i)]
            f0, f1 = (x0 - y0) % P, (x1 - y1) % P
            w0 = (s0 * f0 + 7 * s1 * f1) % P
            w1 = (s0 * f1 + s1 * f0) % P
            cons.append(((deltas[i][0] - w0) % P, (deltas[i][1] - w1) % P))
        state = []
        for i in range(4):
            a, d = wires[self.wire_in(i)], deltas[i]
            state.append(((a[0] + d[0]) % P, (a[1] + d[1]) % P))
        for i in range(4):
            a, d = wires[self.wire_in(i + 4)], deltas[i]
            state.append(((a[0] - d[0]) % P, (a[1] - d[1]) % P))
        for i in range(8, W):
            state.append(wires[self.wire_in(i)])

        # round 0 (full): sbox inputs are linear — not stored
        rc0 = RC[0]
        state = mds(
            [x7(((state[i][0] + rc0[i]) % P, state[i][1])) for i in range(W)]
        )
        # full rounds 1..3: stored sbox inputs
        for r in range(1, 4):
            rcr = RC[r]
            stored = [wires[self.wire_full0(r, i)] for i in range(W)]
            cons.extend(
                (
                    (stored[i][0] - state[i][0] - rcr[i]) % P,
                    (stored[i][1] - state[i][1]) % P,
                )
                for i in range(W)
            )
            state = mds([x7(x) for x in stored])
        # partial rounds: store lane-0 sbox input only
        for pr in range(pos.N_PARTIAL_ROUNDS):
            rcr = RC[4 + pr]
            pre = [
                ((state[i][0] + rcr[i]) % P, state[i][1]) for i in range(W)
            ]
            st = wires[self.wire_partial(pr)]
            cons.append(((st[0] - pre[0][0]) % P, (st[1] - pre[0][1]) % P))
            state = mds([x7(st)] + pre[1:])
        # second-half full rounds: all stored
        for r in range(4):
            rcr = RC[4 + pos.N_PARTIAL_ROUNDS + r]
            stored = [wires[self.wire_full1(r, i)] for i in range(W)]
            cons.extend(
                (
                    (stored[i][0] - state[i][0] - rcr[i]) % P,
                    (stored[i][1] - state[i][1]) % P,
                )
                for i in range(W)
            )
            state = mds([x7(x) for x in stored])
        cons.extend(
            (
                (wires[self.wire_out(i)][0] - state[i][0]) % P,
                (wires[self.wire_out(i)][1] - state[i][1]) % P,
            )
            for i in range(W)
        )
        return cons

    def eval_constraints_torch(self, wires_mat, const_mat, pi_hash):
        """Stacked device evaluation, (123, M) rows in eval_constraints
        order: the 30-round constraint walk vectorised over the coset,
        with the (12, M) state as one tensor.  A round is three field
        launches: its constants' add, its constraint rows, and its S-box
        and MDS layer as one (goldilocks_cuda.mds_full, mds_partial)."""
        import torch

        from ..ops import goldilocks_cuda as gt

        W = self.WIDTH
        dev = wires_mat.device
        rc_all = device_constant(  # (30, 12, 1)
            "poseidon_gate_rc", dev, lambda: gt.from_u64(pos._RC, dev)[:, :, None]
        )

        rows = []
        swap = wires_mat[self.WIRE_SWAP]
        rows.append(gt.sub(gt.mul(swap, swap), swap)[None])
        ins = wires_mat[:W]  # wire_in(i) == i
        deltas = wires_mat[self.wire_delta(0) : self.wire_delta(0) + 4]
        want = gt.mul(swap[None, :], gt.sub(ins[4:8], ins[:4]))
        rows.append(gt.sub(deltas, want))
        state = torch.cat(
            [gt.add(ins[:4], deltas), gt.sub(ins[4:8], deltas), ins[8:W]]
        )
        state = gt.mds_full(gt.add(state, rc_all[0]))

        def full_rounds(state, rounds, wire):
            for k, r in enumerate(rounds):
                stored = wires_mat[wire(k, 0) : wire(k, 0) + W]  # wire(k, i) = wire(k, 0) + i
                rows.append(gt.sub(stored, gt.add(state, rc_all[r])))
                state = gt.mds_full(stored)
            return state

        # full rounds 1..3: stored sbox inputs
        state = full_rounds(
            state, range(1, 4), lambda k, i: self.wire_full0(k + 1, i)
        )
        # partial rounds: stored lane-0 sbox inputs
        for pr in range(pos.N_PARTIAL_ROUNDS):
            stored = wires_mat[self.wire_partial(pr)]
            pre = gt.add(state, rc_all[4 + pr])
            rows.append(gt.sub(stored, pre[0])[None])
            state = gt.mds_partial(stored, pre)
        # second-half full rounds: all stored
        p1 = 4 + pos.N_PARTIAL_ROUNDS
        state = full_rounds(state, range(p1, p1 + 4), self.wire_full1)
        outs = wires_mat[self.wire_out(0) : self.wire_out(0) + W]
        rows.append(gt.sub(outs, state))
        return torch.cat(rows)


@dataclass(frozen=True)
class BitDecompGate(Gate):
    """num_ops independent decompositions of a value into `bits` bits
    (little-endian).  Implements range_check / split_le semantics
    (reference call sites: nullifier.rs:231-233, storage_proof/mod.rs:199,
    gadgets.rs:20 via split_le)."""

    bits: int
    num_ops: int

    @property
    def gid(self):
        return f"bit_decomp<{self.bits},{self.num_ops}>"

    def wires_op(self, i: int):
        base = i * (self.bits + 1)
        return base, [base + 1 + b for b in range(self.bits)]

    def eval_constraints(self, alg, wires, consts, pi_hash):
        cons = []
        for i in range(self.num_ops):
            v_w, bit_ws = self.wires_op(i)
            v = wires[v_w]
            acc = alg.zero()
            for b in reversed(range(self.bits)):
                bit = wires[bit_ws[b]]
                cons.append(alg.sub(alg.mul(bit, bit), bit))
                acc = alg.add(alg.add(acc, acc), bit)
            cons.append(alg.sub(acc, v))
        return cons

    def eval_constraints_torch(self, wires_mat, const_mat, pi_hash):
        """Stacked device evaluation: (num_ops*(bits+1), M) rows in
        eval_constraints order (per op: bool checks MSB-first, then the
        recomposition check)."""
        import torch

        from ..ops import goldilocks_cuda as gt

        v_idx = [self.wires_op(i)[0] for i in range(self.num_ops)]
        bit_idx = np.array(
            [self.wires_op(i)[1] for i in range(self.num_ops)]
        )  # (ops, bits) little-endian
        dev = wires_mat.device
        v = wires_mat[_wire_index(self, "value", v_idx, dev)]  # (ops, M)
        bits = wires_mat[_wire_index(self, "bits", bit_idx.ravel(), dev)].reshape(
            self.num_ops, self.bits, -1
        )  # (ops, bits, M)
        boolcons = gt.sub(gt.mul(bits, bits), bits).flip(1)  # MSB-first
        acc = torch.zeros_like(v)
        for b in reversed(range(self.bits)):
            acc = gt.add(gt.add(acc, acc), bits[:, b])
        sumcons = gt.sub(acc, v)[:, None, :]
        rows = torch.cat([boolcons, sumcons], dim=1)
        return rows.reshape(self.num_ops * (self.bits + 1), -1)


@dataclass(frozen=True)
class ConstantGate(Gate):
    num_consts: int = 2

    @property
    def gid(self):
        return f"constant<{self.num_consts}>"

    def eval_constraints(self, alg, wires, consts, pi_hash):
        return [
            alg.sub(wires[i], consts[i]) for i in range(self.num_consts)
        ]


@dataclass(frozen=True)
class PublicInputGate(Gate):
    @property
    def gid(self):
        return "public_input"

    def eval_constraints(self, alg, wires, consts, pi_hash):
        return [alg.sub(wires[i], pi_hash[i]) for i in range(4)]


@dataclass(frozen=True)
class NoopGate(Gate):
    @property
    def gid(self):
        return "noop"

    def eval_constraints(self, alg, wires, consts, pi_hash):
        return []


# ---------------------------------------------------------------------------
# Witness-side Poseidon trace (fills the gate's internal wires)
# ---------------------------------------------------------------------------


def poseidon_trace(inputs: np.ndarray, swap: np.ndarray):
    """Compute all stored-wire values for PoseidonGate rows.

    inputs: (B, 12) uint64; swap: (B,) uint64 in {0,1}.
    Returns (wire_values: dict wire_index -> (B,) uint64, outputs (B, 12)).
    Mirrors eval_constraints exactly (any mismatch fails proving).
    """
    g = PoseidonGate()
    B = inputs.shape[0]

    from ..native import poseidon_trace_batch

    native = poseidon_trace_batch(inputs, swap)
    if native is not None:
        d, stored, outs = native
        values = {}
        for i in range(4):
            values[g.wire_delta(i)] = d[:, i]
        for r in range(1, 4):
            for i in range(12):
                values[g.wire_full0(r, i)] = stored[:, (r - 1) * 12 + i]
        for pr in range(pos.N_PARTIAL_ROUNDS):
            values[g.wire_partial(pr)] = stored[:, 36 + pr]
        for r in range(4):
            for i in range(12):
                values[g.wire_full1(r, i)] = stored[
                    :, 36 + pos.N_PARTIAL_ROUNDS + r * 12 + i
                ]
        return values, outs

    values: dict[int, np.ndarray] = {}
    deltas = []
    for i in range(4):
        d = gl.mul(swap, gl.sub(inputs[:, i + 4], inputs[:, i]))
        values[g.wire_delta(i)] = d
        deltas.append(d)
    state = inputs.copy().T  # (12, B)
    for i in range(4):
        state[i] = gl.add(state[i], deltas[i])
        state[i + 4] = gl.sub(state[i + 4], deltas[i])

    RC = pos._RC

    def mds(st):
        return pos._mds(st.T).T

    def x7(x):
        x2 = gl.mul(x, x)
        x3 = gl.mul(x2, x)
        return gl.mul(gl.mul(x2, x2), x3)

    # round 0
    pre = gl.add(state, RC[0][:, None])
    state = mds(x7(pre))
    for r in range(1, 4):
        pre = gl.add(state, RC[r][:, None])
        for i in range(12):
            values[g.wire_full0(r, i)] = pre[i]
        state = mds(x7(pre))
    for pr in range(pos.N_PARTIAL_ROUNDS):
        r = 4 + pr
        pre = gl.add(state, RC[r][:, None])
        values[g.wire_partial(pr)] = pre[0]
        sb = pre.copy()
        sb[0] = x7(pre[0])
        state = mds(sb)
    for r in range(4):
        rr = 4 + pos.N_PARTIAL_ROUNDS + r
        pre = gl.add(state, RC[rr][:, None])
        for i in range(12):
            values[g.wire_full1(r, i)] = pre[i]
        state = mds(x7(pre))
    return values, state.T  # outputs (B, 12)
