"""The constraints of each gate of the circuits, evaluated at one point of
the quadratic extension (values are (c0, c1) pairs of Python integers).
Each gate id names its wire layout; the constraint order is the order the
vanishing polynomial combines them in."""

from __future__ import annotations

import re

from . import field as F
from .poseidon import HALF_FULL, MDS, PARTIAL, WIDTH, _RC

P = F.P
_RC_INT = [[int(v) for v in row] for row in _RC]


def _mul(a, b):
    return F.e_mul(a, b)


def _sub(a, b):
    return F.e_sub(a, b)


def _add(a, b):
    return F.e_add(a, b)


def arithmetic(num_ops: int, w, c, pi):
    """out_i = c0 * m0_i * m1_i + c1 * a_i on wires 4i .. 4i + 3."""
    out = []
    for i in range(num_ops):
        m0, m1, a, o = w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]
        out.append(_sub(_add(_mul(c[0], _mul(m0, m1)), _mul(c[1], a)), o))
    return out


def bit_decomp(bits: int, num_ops: int, w, c, pi):
    """num_ops values, each with its bits little-endian on the next wires:
    each bit boolean (most significant first), then the recomposition."""
    out = []
    for i in range(num_ops):
        base = i * (bits + 1)
        acc = (0, 0)
        for b in reversed(range(bits)):
            bit = w[base + 1 + b]
            out.append(_sub(_mul(bit, bit), bit))
            acc = _add(_add(acc, acc), bit)
        out.append(_sub(acc, w[base]))
    return out


def constant(num_consts: int, w, c, pi):
    return [_sub(w[i], c[i]) for i in range(num_consts)]


def public_input(w, c, pi):
    return [_sub(w[i], pi[i]) for i in range(4)]


def _x7(x):
    x2 = _mul(x, x)
    return _mul(_mul(x2, x2), _mul(x2, x))


def _mds(state):
    out = []
    for row in MDS:
        s0 = sum(m * v[0] for m, v in zip(row, state))
        s1 = sum(m * v[1] for m, v in zip(row, state))
        out.append((s0 % P, s1 % P))
    return out


def poseidon(w, c, pi):
    """One permutation a row.  Wires: 0-11 inputs, 12-23 outputs, 24 the
    swap flag, 25-28 the swap deltas, 29-64 the S-box inputs of full
    rounds 1-3, 65-86 those of the partial rounds, 87-134 those of the
    last four full rounds."""
    cons = []
    swap = w[24]
    cons.append(_sub(_mul(swap, swap), swap))
    deltas = [w[25 + i] for i in range(4)]
    for i in range(4):
        cons.append(_sub(deltas[i], _mul(swap, _sub(w[i + 4], w[i]))))
    state = ([_add(w[i], deltas[i]) for i in range(4)]
             + [_sub(w[i + 4], deltas[i]) for i in range(4)]
             + [w[i] for i in range(8, WIDTH)])

    def with_rc(st, r):
        return [((x[0] + _RC_INT[r][i]) % P, x[1]) for i, x in enumerate(st)]

    state = _mds([_x7(x) for x in with_rc(state, 0)])
    for r in range(1, HALF_FULL):
        pre = with_rc(state, r)
        stored = [w[29 + (r - 1) * WIDTH + i] for i in range(WIDTH)]
        cons.extend(_sub(stored[i], pre[i]) for i in range(WIDTH))
        state = _mds([_x7(x) for x in stored])
    for k in range(PARTIAL):
        pre = with_rc(state, HALF_FULL + k)
        stored = w[65 + k]
        cons.append(_sub(stored, pre[0]))
        state = _mds([_x7(stored)] + pre[1:])
    for r in range(HALF_FULL):
        pre = with_rc(state, HALF_FULL + PARTIAL + r)
        stored = [w[87 + r * WIDTH + i] for i in range(WIDTH)]
        cons.extend(_sub(stored[i], pre[i]) for i in range(WIDTH))
        state = _mds([_x7(x) for x in stored])
    cons.extend(_sub(w[12 + i], state[i]) for i in range(WIDTH))
    return cons


def constraints(gate_id: str, wires, consts, pi_hash) -> list:
    if m := re.fullmatch(r"arithmetic<(\d+)>", gate_id):
        return arithmetic(int(m.group(1)), wires, consts, pi_hash)
    if m := re.fullmatch(r"bit_decomp<(\d+),(\d+)>", gate_id):
        return bit_decomp(int(m.group(1)), int(m.group(2)), wires, consts, pi_hash)
    if m := re.fullmatch(r"constant<(\d+)>", gate_id):
        return constant(int(m.group(1)), wires, consts, pi_hash)
    if gate_id == "poseidon<12>":
        return poseidon(wires, consts, pi_hash)
    if gate_id == "public_input":
        return public_input(wires, consts, pi_hash)
    if gate_id == "noop":
        return []
    raise ValueError(f"unknown gate {gate_id!r}")
