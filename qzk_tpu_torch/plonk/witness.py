"""Witness generation: PartialWitness + levelized batched generators.

Semantics parity with the reference's witness layer (PartialWitness
set_target / set_target_arr / set_hash_target / set_bool_target, and the
"set twice with different values" conflict detection its negative tests
rely on — reference wormhole/tests/src/circuit/storage_proof_tests.rs:31-100).

Vectorized design: instead of a scalar worklist solver, the builder's
generator list (already topologically ordered by construction) is
levelized once at build time into batches of independent same-kind
generators; each batch executes as one vectorized numpy sweep (Poseidon
batches run the full (B, 12) batched permutation).  This keeps host-side
witness generation off the critical path.  The native executor runs the
wide batches whose items touch disjoint roots on a few host threads
(_NativePlan, native/poseidon_native.cc).  The partial witness holds its
values as arrays indexed by target, set and read in bulk: a chunk fill
is a few array calls, and seeding the generators one scatter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import goldilocks as gl
from ..utils import spans
from .builder import BoolTarget, HashOutTarget


class WitnessConflict(ValueError):
    """Raised when a target is set twice with different values."""

    def __init__(self, target):
        super().__init__(
            f"set twice with different values: target {target}"
        )


class PartialWitness:
    """The values set so far, as arrays indexed by target id: `_vals`
    (canonical, uint64), `_set` (bool) and `_order` (int64: where in the
    sequence of set values a target was first set, so that a conflict
    names the target a walk in set order meets first).  The arrays grow
    by doubling.  `set_calls` counts the calls of the set_* methods."""

    def __init__(self):
        self._vals = np.zeros(0, dtype=np.uint64)
        self._set = np.zeros(0, dtype=bool)
        self._order = np.zeros(0, dtype=np.int64)
        self._next = 0  # the order of the next value set
        self.set_calls = 0

    def _reserve(self, top: int) -> None:
        """Room for target id `top`."""
        n = len(self._set)
        if top < n:
            return
        size = max(2 * n, top + 1, 1024)
        for name in ("_vals", "_set", "_order"):
            old = getattr(self, name)
            new = np.zeros(size, dtype=old.dtype)
            new[:n] = old
            setattr(self, name, new)

    def set_target(self, t: int, value) -> None:
        self.set_calls += 1
        value = int(value) % gl.P
        self._reserve(int(t))
        if self._set[t]:
            if int(self._vals[t]) != value:
                raise WitnessConflict(t)
            return
        self._vals[t] = value
        self._set[t] = True
        self._order[t] = self._next
        self._next += 1

    def set_target_arr(self, targets, values) -> None:
        self.set_calls += 1
        self._set_arr(targets, values)

    def _set_arr(self, targets, values) -> None:
        """set_target over the pairs in order, as one scatter: a clash
        (with a value set before, or between two places of one target in
        this call) raises on the first clashing place, after the places
        before it are set."""
        ts = np.asarray(targets, dtype=np.int64).ravel()
        vs = np.asarray(values, dtype=np.uint64).ravel()
        assert len(ts) == len(vs), (
            f"target/value length mismatch: {len(ts)} vs {len(vs)}"
        )
        if not len(ts):
            return
        vs = vs % np.uint64(gl.P)
        self._reserve(int(ts.max()))
        was = self._set[ts]
        fresh = ~was
        if not (was & (self._vals[ts] != vs)).any():
            self._vals[ts[fresh]] = vs[fresh]
            # equal read-backs: no target twice in the call with two values
            if (self._vals[ts] == vs).all():
                new_ts = ts[fresh]
                order = self._next + np.flatnonzero(fresh)
                self._set[new_ts] = True
                self._order[new_ts] = order
                if (self._order[new_ts] != order).any():  # a target twice: its first place
                    np.minimum.at(self._order, new_ts, order)
                self._next += len(ts)
                return
        # what each place meets in a walk in order: the value set before
        # the call, else the value at the target's first place in the call
        _, first, inv = np.unique(ts, return_index=True, return_inverse=True)
        met = np.where(was, self._vals[ts], vs[first[inv.ravel()]])
        i = int(np.flatnonzero(met != vs)[0])
        self._set_arr(ts[:i], vs[:i])
        raise WitnessConflict(int(ts[i]))

    def set_hash_target(self, h: HashOutTarget, digest) -> None:
        digest = np.asarray(digest, dtype=np.uint64).ravel()
        assert digest.shape == (4,)
        self.set_target_arr(h.elements, digest)

    def set_bool_target(self, b: BoolTarget, value: bool) -> None:
        self.set_target(b.target, 1 if value else 0)

    @property
    def num_values(self) -> int:
        """The number of targets set."""
        return int(np.count_nonzero(self._set))

    def set_arrays(self):
        """(targets, values, order) of the targets set, by target id."""
        ts = np.flatnonzero(self._set)
        return ts, self._vals[ts], self._order[ts]

    @property
    def values(self) -> dict:
        """{target: value} in the order the targets were first set, built
        on each read (for tests and tools; a prove reads set_arrays)."""
        ts, vs, order = self.set_arrays()
        by = np.argsort(order, kind="stable")
        return dict(zip(ts[by].tolist(), vs[by].tolist()))


# ---------------------------------------------------------------------------
# Levelized generator batches (built once per circuit)
# ---------------------------------------------------------------------------


@dataclass
class GeneratorBatches:
    """Precompiled batch plan: list of (kind, payload) in execution order."""

    batches: list
    num_targets: int
    roots: np.ndarray  # target -> union-find root

    def __getstate__(self):
        """The pickled state leaves out the native plan that the first
        run_generators derives and stores here (`_native_plan`), so that
        a plan pickles the same before and after a prove."""
        state = dict(self.__dict__)
        state.pop("_native_plan", None)
        return state


def compile_generators(builder) -> GeneratorBatches:
    # all union-find roots at once (pointer jumping — the per-target
    # python _find walk was ~0.3 s of the circuit build)
    parent = np.asarray(builder._parent, dtype=np.int64)
    roots = parent.copy()
    while True:
        nxt = roots[roots]
        if np.array_equal(nxt, roots):
            break
        roots = nxt
    target_level: dict[int, int] = {}

    def lvl_of(t) -> int:
        return target_level.get(int(roots[t]), 0)

    staged: dict[tuple, list] = {}
    for gen in builder.generators:
        kind = gen.kind
        if kind == "const":
            t, value = gen.data
            level = 1
            key = (level, "const")
            staged.setdefault(key, []).append((t, value))
            outs = [t]
        elif kind == "arith":
            c0, c1, m0, m1, a, out = gen.data
            level = 1 + max(lvl_of(m0), lvl_of(m1), lvl_of(a))
            key = (level, "arith")
            staged.setdefault(key, []).append((c0, c1, m0, m1, a, out))
            outs = [out]
        elif kind == "inv_or_zero":
            x, out = gen.data
            level = 1 + lvl_of(x)
            key = (level, "inv_or_zero")
            staged.setdefault(key, []).append((x, out))
            outs = [out]
        elif kind == "bits":
            value_t, bit_ts = gen.data
            level = 1 + lvl_of(value_t)
            key = (level, "bits", len(bit_ts))
            staged.setdefault(key, []).append((value_t, bit_ts))
            outs = list(bit_ts)
        elif kind == "poseidon":
            in_ts, swap_t, internal, out_ts = gen.data
            level = 1 + max(
                max(lvl_of(t) for t in in_ts), lvl_of(swap_t)
            )
            key = (level, "poseidon")
            staged.setdefault(key, []).append(
                (in_ts, swap_t, internal, out_ts)
            )
            outs = list(out_ts) + [t for _, t in internal]
        else:  # pragma: no cover
            raise ValueError(f"unknown generator kind {kind}")
        for t in outs:
            r = int(roots[t])
            target_level[r] = max(target_level.get(r, 0), level)

    batches = [staged[k] for k in sorted(staged, key=lambda k: (k[0], str(k)))]
    kinds = [k[1] for k in sorted(staged, key=lambda k: (k[0], str(k)))]
    return GeneratorBatches(
        batches=list(zip(kinds, batches)),
        num_targets=builder._num_targets,
        roots=roots,
    )


# The narrowest batches the native executor splits across its threads,
# in items: below them a batch takes less time than handing it out.
SPLIT_MIN_ARITH = 512
SPLIT_MIN_POSEIDON = 16  # two 8-way groups
# The fewest items a plan's splittable batches hold for it to split any:
# fewer take less time alone than waking the sleeping threads costs.
SPLIT_MIN_PLAN = 1 << 15


def _may_split(outs: np.ndarray, ins: np.ndarray) -> bool:
    """Whether a batch's items may run in any order, on several threads:
    its output roots pairwise distinct and none of them an input root."""
    return len(np.unique(outs)) == len(outs) and not np.isin(outs, ins).any()


class _NativePlan:
    """Flat-array encoding of a GeneratorBatches plan for the one-call
    C executor (native/poseidon_native.cc run_witness_plan).  All ids
    are pre-resolved union-find roots; built once per circuit.  The last
    column of `batch_table` is 1 for an arith or Poseidon batch that the
    executor may split across threads: at least SPLIT_MIN_ARITH or
    SPLIT_MIN_POSEIDON items wide, and _may_split, in a plan whose such
    batches hold SPLIT_MIN_PLAN items or more."""

    def __init__(self, plan: "GeneratorBatches"):
        from ..ops import poseidon as pos
        from .gates import PoseidonGate

        g = PoseidonGate()
        canonical = (
            [g.wire_delta(i) for i in range(4)]
            + [g.wire_full0(r, i) for r in range(1, 4) for i in range(12)]
            + [g.wire_partial(pr) for pr in range(pos.N_PARTIAL_ROUNDS)]
            + [g.wire_full1(r, i) for r in range(4) for i in range(12)]
        )
        roots = plan.roots
        table = []
        const_ids, const_vals = [], []
        a_c0, a_c1, a_m0, a_m1, a_a, a_out = [], [], [], [], [], []
        inv_x, inv_out = [], []
        bits_val, bits_out = [], []
        pos_in, pos_swap, pos_internal, pos_out = [], [], [], []

        def r(t):
            return int(roots[t])

        for kind, items in plan.batches:
            if kind == "const":
                table.append([0, len(const_ids), len(items), 0, 0, 0])
                for t, v in items:
                    const_ids.append(r(t))
                    const_vals.append(int(v) % gl.P)
            elif kind == "arith":
                table.append([1, len(a_c0), len(items), 0, 0, 0])
                for c0, c1, m0, m1, a, out in items:
                    a_c0.append(int(c0) % gl.P)
                    a_c1.append(int(c1) % gl.P)
                    a_m0.append(r(m0))
                    a_m1.append(r(m1))
                    a_a.append(r(a))
                    a_out.append(r(out))
            elif kind == "inv_or_zero":
                table.append([2, len(inv_x), len(items), 0, 0, 0])
                for x, out in items:
                    inv_x.append(r(x))
                    inv_out.append(r(out))
            elif kind == "bits":
                nbits = len(items[0][1])
                table.append(
                    [3, len(bits_val), len(items), nbits, len(bits_out), 0]
                )
                for value_t, bit_ts in items:
                    assert len(bit_ts) == nbits
                    bits_val.append(r(value_t))
                    bits_out.extend(r(t) for t in bit_ts)
            elif kind == "poseidon":
                table.append([4, len(pos_swap), len(items), 0, 0, 0])
                for in_ts, swap_t, internal, out_ts in items:
                    assert [w for w, _ in internal] == canonical
                    pos_in.extend(r(t) for t in in_ts)
                    pos_swap.append(r(swap_t))
                    pos_internal.extend(r(t) for _, t in internal)
                    pos_out.extend(r(t) for t in out_ts)
            else:  # pragma: no cover
                raise ValueError(f"unknown generator kind {kind}")

        def i64(x):
            return np.ascontiguousarray(x, dtype=np.int64)

        def u64(x):
            return np.ascontiguousarray(x, dtype=np.uint64)

        self.batch_table = i64(table).reshape(-1, 6)
        self.const_ids, self.const_vals = i64(const_ids), u64(const_vals)
        self.arith_c0, self.arith_c1 = u64(a_c0), u64(a_c1)
        self.arith_m0, self.arith_m1 = i64(a_m0), i64(a_m1)
        self.arith_a, self.arith_out = i64(a_a), i64(a_out)
        self.inv_x, self.inv_out = i64(inv_x), i64(inv_out)
        self.bits_val, self.bits_out = i64(bits_val), i64(bits_out)
        self.pos_in, self.pos_swap = i64(pos_in), i64(pos_swap)
        self.pos_internal, self.pos_out = i64(pos_internal), i64(pos_out)

        n_int = len(canonical)
        for row in self.batch_table:
            kind, s, c = (int(x) for x in row[:3])
            if kind == 1 and c >= SPLIT_MIN_ARITH:
                e = slice(s, s + c)
                ins = (self.arith_m0[e], self.arith_m1[e], self.arith_a[e])
                row[5] = _may_split(self.arith_out[e], np.concatenate(ins))
            elif kind == 4 and c >= SPLIT_MIN_POSEIDON:
                outs = (self.pos_out[12 * s:12 * (s + c)],
                        self.pos_internal[n_int * s:n_int * (s + c)])
                ins = (self.pos_in[12 * s:12 * (s + c)], self.pos_swap[s:s + c])
                row[5] = _may_split(np.concatenate(outs), np.concatenate(ins))
        table = self.batch_table
        if table[table[:, 5] == 1, 2].sum() < SPLIT_MIN_PLAN:
            table[:, 5] = 0


def _native_plan_for(plan: GeneratorBatches) -> "_NativePlan | None":
    try:
        cached = plan._native_plan
    except AttributeError:
        cached = None
    if cached is None:
        try:
            cached = _NativePlan(plan)
        except AssertionError:  # unexpected layout: fall back to numpy
            cached = False
        plan._native_plan = cached
    return cached or None


def run_generators(
    plan: GeneratorBatches, pw: PartialWitness
) -> tuple[np.ndarray, np.ndarray]:
    """Execute all generator batches; returns (values, known) arrays
    indexed by union-find root.  The span "witness.generators", with the
    attributes `values` (the targets seeded) and `set_calls` (the set_*
    calls that set them), and at its end `threads` (the threads the
    generators ran on), `split_items` (the items of the batches split
    across them) and `items` (all the generators)."""
    with spans.span("witness.generators",
                    attrs={"values": pw.num_values, "set_calls": pw.set_calls}):
        values, known, (threads, split_items, items) = _run_generators(plan, pw)
        spans.set_attrs(threads=threads, split_items=split_items, items=items)
        return values, known


def _seed_conflict(ts, vs, order, rs) -> int:
    """The target a walk over the set targets in set order first finds
    clashing with an earlier one of its union-find root."""
    by = np.lexsort((order, rs))
    rs, vs, order = rs[by], vs[by], order[by]
    clash = np.flatnonzero((rs[1:] == rs[:-1]) & (vs[1:] != vs[:-1])) + 1
    return int(ts[by][clash[np.argmin(order[clash])]])


def seed_values(plan: GeneratorBatches, pw: PartialWitness):
    """(values, known) indexed by union-find root, holding the partial
    witness's values: one scatter."""
    values = np.zeros(plan.num_targets, dtype=np.uint64)
    known = np.zeros(plan.num_targets, dtype=bool)
    ts, vs, order = pw.set_arrays()
    rs = plan.roots[ts]
    values[rs] = vs
    # equal read-backs: every root's targets agree
    if not (values[rs] == vs).all():
        raise WitnessConflict(_seed_conflict(ts, vs, order, rs))
    known[rs] = True
    return values, known


def _run_generators(plan: GeneratorBatches, pw: PartialWitness):
    from .gates import poseidon_trace

    roots = plan.roots
    values, known = seed_values(plan, pw)

    native_plan = _native_plan_for(plan)
    if native_plan is not None:
        from ..native import run_witness_plan

        result = run_witness_plan(values, known, native_plan)
        if result is not None:
            code, err = result
            if code == 0:
                return values, known, tuple(int(x) for x in err[4:7])
            if code == 1:
                raise ValueError(f"witness targets not set: [{err[0]}]")
            if code == 2:
                raise WitnessConflict(int(err[0]))
            if code == 3:
                raise ValueError(
                    f"value {int(np.uint64(err[1]))} does not fit in "
                    f"{int(err[2])} bits (range check failed at witness time)"
                )
            raise RuntimeError(f"native witness plan failed: code {code}")

    def read(ts) -> np.ndarray:
        idx = roots[np.asarray(ts, dtype=np.int64)]
        if not known[idx].all():
            missing = np.asarray(ts)[~known[idx]][:5]
            raise ValueError(f"witness targets not set: {missing}")
        return values[idx]

    def write(ts, vals) -> None:
        idx = roots[np.asarray(ts, dtype=np.int64)]
        vals = np.asarray(vals, dtype=np.uint64)
        clash = known[idx] & (values[idx] != vals)
        if clash.any():
            raise WitnessConflict(np.asarray(ts)[clash][0])
        values[idx] = vals
        known[idx] = True

    for kind, items in plan.batches:
        if kind == "const":
            ts = [t for t, _ in items]
            vs = [v for _, v in items]
            write(ts, np.array(vs, dtype=np.uint64))
        elif kind == "arith":
            c0 = np.array([i[0] for i in items], dtype=np.uint64)
            c1 = np.array([i[1] for i in items], dtype=np.uint64)
            m0 = read([i[2] for i in items])
            m1 = read([i[3] for i in items])
            a = read([i[4] for i in items])
            out = gl.add(gl.mul(c0, gl.mul(m0, m1)), gl.mul(c1, a))
            write([i[5] for i in items], out)
        elif kind == "inv_or_zero":
            x = read([i[0] for i in items])
            out = np.zeros_like(x)
            nz = x != 0
            if nz.any():
                out[nz] = gl.batch_inverse(x[nz])
            write([i[1] for i in items], out)
        elif kind == "bits":
            v = read([i[0] for i in items])
            nbits = len(items[0][1])
            if nbits < 64:
                too_big = v >> np.uint64(nbits)
                if too_big.any():
                    bad = np.where(too_big)[0][0]
                    raise ValueError(
                        f"value {int(v[bad])} does not fit in {nbits} bits "
                        "(range check failed at witness time)"
                    )
            bits = (v[:, None] >> np.arange(nbits, dtype=np.uint64)) & np.uint64(1)
            all_ts = [t for _, bit_ts in items for t in bit_ts]
            write(all_ts, bits.ravel())
        elif kind == "poseidon":
            ins = read([t for i in items for t in i[0]]).reshape(-1, 12)
            swaps = read([i[1] for i in items])
            wire_vals, outs = poseidon_trace(ins, swaps)
            # internal wires: same layout for every row in the batch
            internal_ts = [t for i in items for _, t in i[2]]
            internal_wires = [w for w, _ in items[0][2]]
            per_row = np.stack(
                [wire_vals[w] for w in internal_wires], axis=1
            )  # (B, n_internal)
            write(internal_ts, per_row.ravel())
            write([t for i in items for t in i[3]], outs.ravel())
    return values, known, (1, 0, sum(len(items) for _, items in plan.batches))
