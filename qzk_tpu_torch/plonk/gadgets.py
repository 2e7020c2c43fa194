"""Shared circuit gadgets (parity with the reference's
common/src/gadgets.rs:14-65)."""

from __future__ import annotations

from .builder import BoolTarget, CircuitBuilder, Target


def xor(builder: CircuitBuilder, a: BoolTarget, b: BoolTarget) -> BoolTarget:
    """a XOR b = a + b - 2ab (gadgets.rs:53-65)."""
    ab = builder.mul(a.target, b.target)
    two_ab = builder.mul_const(2, ab)
    a_plus_b = builder.add(a.target, b.target)
    return BoolTarget(builder.sub(a_plus_b, two_ab))


def is_const_less_than(
    builder: CircuitBuilder, left: int, right: Target, n_log: int
) -> BoolTarget:
    """left (constant) < right (target), both < 2^n_log, via an MSB-first
    compare over the bit decomposition of `right` (gadgets.rs:14-41)."""
    right_bits = builder.split_le(right, n_log)
    left_bits = [((left >> i) & 1) != 0 for i in range(n_log)]

    lt = builder._false()
    eq = builder._true()
    for i in reversed(range(n_log)):
        a = builder.constant_bool(left_bits[i])
        b = right_bits[i]
        not_a = builder.not_(a)
        not_a_and_b = builder.and_(not_a, b)
        this_lt = builder.and_(not_a_and_b, eq)
        lt = builder.or_(lt, this_lt)
        a_xor_b = xor(builder, a, b)
        not_xor = builder.not_(a_xor_b)
        eq = builder.and_(eq, not_xor)
    return lt
