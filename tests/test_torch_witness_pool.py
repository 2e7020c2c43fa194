"""The native witness executor's thread pool (qzk_tpu_torch/native/
poseidon_native.cc::run_witness_plan, the marks of plonk/witness.py::
_NativePlan): a batch whose output roots are pairwise distinct and not
among its input roots, arith of 512 items or more or Poseidon of 16 or
more, runs in ranges on several host threads, in a plan whose such
batches hold 2^15 items or more.  The synthetic plans here are smaller:
their tests lower that floor to 0.

- synthetic plans of wide arith and Poseidon batches give the serial
  executor's `values` and `known` byte for byte, and the numpy path's;
- an unset input or a clashing output planted in two ranges of a split
  batch reports the serial (code, target): the lowest item's;
- a batch that repeats an output root, or reads one of its own, is not
  marked and reports its conflict as before;
- two Python threads running plans at once both get the serial arrays,
  and one of them, finding the pool held, runs alone;
- a plan whose splittable batches hold too few items marks none: the
  zk Wormhole leaf's marks nothing; the leaf and the (2, 1) chunk give
  the serial arrays through the pool.
"""

import os
import threading

import numpy as np
import pytest
import torch

from qzk_tpu_torch import native
from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit, fill_all_targets
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import poseidon as pos
from qzk_tpu_torch.plonk import recursion as rec
from qzk_tpu_torch.plonk import witness as wit
from qzk_tpu_torch.plonk.config import CircuitConfig
from qzk_tpu_torch.plonk.gates import PoseidonGate
from qzk_tpu_torch.plonk.proof import ProofWithPublicInputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pool's size on this host: at most 4 threads, at most half the cores
POOL = max(1, min(4, len(os.sched_getaffinity(0)) // 2))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def no_chunk_disk_cache():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", "")
        yield


@pytest.fixture
def any_plan_splits(monkeypatch):
    monkeypatch.setattr(wit, "SPLIT_MIN_PLAN", 0)


def _canonical():
    g = PoseidonGate()
    return ([g.wire_delta(i) for i in range(4)]
            + [g.wire_full0(r, i) for r in range(1, 4) for i in range(12)]
            + [g.wire_partial(pr) for pr in range(pos.N_PARTIAL_ROUNDS)]
            + [g.wire_full1(r, i) for r in range(4) for i in range(12)])


class Synthetic:
    """A plan of generator batches over fresh targets, each batch reading
    what the ones before it wrote; `seeds` are the targets set first."""

    def __init__(self, rng, n_seeds=64):
        self.rng = rng
        self.n = n_seeds
        self.seeds = list(range(n_seeds))
        self.written = list(self.seeds)
        self.batches = []
        self.merges = []  # (target, target it is a copy of)

    def fresh(self, k):
        ts = list(range(self.n, self.n + k))
        self.n += k
        return ts

    def pick(self, k):
        return [int(t) for t in self.rng.choice(self.written, size=k)]

    def felts(self, k):
        return [int(x) for x in self.rng.integers(0, gl.P, size=k, dtype=np.uint64)]

    def arith(self, count, outs=None):
        outs = self.fresh(count) if outs is None else outs
        c0, c1 = self.felts(count), self.felts(count)
        m0, m1, a = self.pick(count), self.pick(count), self.pick(count)
        self.batches.append(("arith", list(zip(c0, c1, m0, m1, a, outs))))
        self.written += outs
        return outs

    def poseidon(self, count):
        canonical = _canonical()
        items = []
        for _ in range(count):
            ins, swap = self.pick(12), self.pick(1)[0]
            internal = list(zip(canonical, self.fresh(len(canonical))))
            items.append((ins, swap, internal, self.fresh(12)))
        self.batches.append(("poseidon", items))
        for _, _, internal, outs in items:
            self.written += [t for _, t in internal] + outs
        return items

    def const(self, count):
        outs = self.fresh(count)
        self.batches.append(("const", list(zip(outs, self.felts(count)))))
        self.written += outs

    def plan(self):
        roots = np.arange(self.n, dtype=np.int64)
        for t, r in self.merges:
            roots[t] = r
        return wit.GeneratorBatches(batches=list(self.batches), num_targets=self.n,
                                    roots=roots)

    def witness(self, extra=()):
        pw = wit.PartialWitness()
        pw.set_target_arr(self.seeds, self.felts(len(self.seeds)))
        for t, v in extra:
            pw.set_target(t, v)
        return pw


def _wide(rng):
    """Wide and narrow batches of every splittable kind, a Poseidon batch
    of whole groups and one with a tail."""
    s = Synthetic(rng)
    s.const(40)
    s.arith(2000)
    s.poseidon(45)
    s.arith(300)
    s.poseidon(32)
    s.arith(777)
    s.poseidon(7)
    s.arith(513)
    return s


def _run(plan, pw, max_threads):
    values, known = wit.seed_values(plan, pw)
    code, err = native.run_witness_plan(values, known, wit._native_plan_for(plan),
                                        max_threads=max_threads)
    return values, known, int(code), err


def test_split_batches_give_the_serial_arrays(any_plan_splits):
    s = _wide(np.random.default_rng(1))
    plan, pw = s.plan(), s.witness()
    marks = wit._native_plan_for(plan).batch_table[:, [0, 2, 5]].tolist()
    assert marks == [[0, 40, 0], [1, 2000, 1], [4, 45, 1], [1, 300, 0], [4, 32, 1],
                     [1, 777, 1], [4, 7, 0], [1, 513, 1]]
    serial = _run(plan, pw, 1)
    pooled = _run(plan, pw, 0)
    assert serial[2] == pooled[2] == 0
    assert serial[0].tobytes() == pooled[0].tobytes()
    assert serial[1].tobytes() == pooled[1].tobytes()
    assert serial[1].all()
    items = 40 + 2000 + 45 + 300 + 32 + 777 + 7 + 513
    assert serial[3][4:7].tolist() == [1, 0, items]
    split = 2000 + 45 + 32 + 777 + 513
    assert pooled[3][4:7].tolist() == ([POOL, split, items] if POOL > 1 else [1, 0, items])
    # the numpy path, which never splits, agrees
    numpy_plan = s.plan()
    numpy_plan._native_plan = False
    values, known = wit.run_generators(numpy_plan, pw)
    assert values.tobytes() == serial[0].tobytes()
    assert known.tobytes() == serial[1].tobytes()


def _planted(kind, code, rng):
    """A split batch with a fault planted in two of its ranges (items at
    about 0.3 and 0.85 of it, so in two ranges for 2 and for 4 threads):
    an input never set (code 1) or an output set before to another value
    (code 2).  Gives the plan, its partial witness and the target the
    serial walk names."""
    s = Synthetic(rng)
    s.arith(600)
    extra, named = [], None
    if kind == "arith":
        count = 2000
        before = len(s.batches)
        outs = s.arith(count)
        items = s.batches[before][1]
        for i in (int(0.3 * count), int(0.85 * count)):
            c0, c1, m0, m1, a, out = items[i]
            if code == 1:
                unset = s.fresh(1)[0]
                items[i] = (c0, c1, m0, unset, a, out)
                named = unset if named is None else named
            else:
                extra.append((outs[i], 12345 + i))
                named = outs[i] if named is None else named
    else:
        count = 48  # 6 groups: 4 threads take items 0-7, 8-23, 24-31, 32-47
        items = s.poseidon(count)
        for i in (13, 40):
            ins, swap, internal, outs = items[i]
            if code == 1:
                unset = s.fresh(1)[0]
                items[i] = (ins[:5] + [unset] + ins[6:], swap, internal, outs)
                named = unset if named is None else named
            else:
                t = internal[50][1] if i == 13 else outs[3]
                extra.append((t, 777 + i))
                named = t if named is None else named
    s.arith(700)
    return s.plan(), s.witness(extra), named


@pytest.mark.parametrize("code", [1, 2])
@pytest.mark.parametrize("kind", ["arith", "poseidon"])
def test_a_fault_in_two_ranges_reports_the_lowest_item(kind, code, any_plan_splits):
    plan, pw, named = _planted(kind, code, np.random.default_rng(10 * code))
    assert wit._native_plan_for(plan).batch_table[1, 5] == 1
    _, _, serial_code, serial_err = _run(plan, pw, 1)
    _, _, pooled_code, pooled_err = _run(plan, pw, 0)
    assert (serial_code, int(serial_err[0])) == (code, named)
    assert (pooled_code, int(pooled_err[0])) == (code, named)
    assert pooled_err[4] == POOL
    with pytest.raises(wit.WitnessConflict if code == 2 else ValueError,
                       match=str(named)):
        wit.run_generators(plan, pw)


def _repeats_an_output(s):
    """Items 100 and 700 write one root: the second clashes."""
    outs = s.fresh(1000)
    s.merges.append((outs[700], outs[100]))
    s.arith(1000, outs=outs)
    return 2, outs[100]


def _reads_an_output(s):
    """Item 950 reads what item 100 writes: in order, it is set."""
    outs = s.arith(1000)
    c0, c1, _, m1, a, out = s.batches[-1][1][950]
    s.batches[-1][1][950] = (c0, c1, outs[100], m1, a, out)
    return 0, None


@pytest.mark.parametrize("make", [_repeats_an_output, _reads_an_output])
def test_a_batch_that_shares_roots_is_not_split(make, any_plan_splits):
    s = Synthetic(np.random.default_rng(3))
    s.arith(600)
    code, named = make(s)
    plan, pw = s.plan(), s.witness()
    assert wit._native_plan_for(plan).batch_table[:, 5].tolist() == [1, 0]
    serial, pooled = _run(plan, pw, 1), _run(plan, pw, 0)
    assert pooled[2] == serial[2] == code
    assert pooled[3][4:7].tolist() == ([POOL, 600, 1600] if POOL > 1 else [1, 0, 1600])
    if code:
        assert int(serial[3][0]) == int(pooled[3][0]) == named
        with pytest.raises(wit.WitnessConflict, match=str(named)):
            wit.run_generators(plan, pw)
    else:
        assert serial[0].tobytes() == pooled[0].tobytes()
        assert serial[1].tobytes() == pooled[1].tobytes()


def _chain(rng, width, depth):
    """A _NativePlan of `depth` arith batches of `width` items, each
    reading the one before: built as arrays, without a GeneratorBatches."""
    plan = object.__new__(wit._NativePlan)
    n = width * (depth + 1)
    prev = np.arange(width)
    m0, m1, a = ([], [], [])
    for d in range(depth):
        for col in (m0, m1, a):
            col.append(rng.choice(prev, size=width))
        prev = np.arange(width * (d + 1), width * (d + 2))
    table = [[1, d * width, width, 0, 0, 1] for d in range(depth)]
    plan.batch_table = np.asarray(table, dtype=np.int64)
    empty = np.zeros(0, dtype=np.int64)
    for name in ("const_ids", "inv_x", "inv_out", "bits_val", "bits_out", "pos_in",
                 "pos_swap", "pos_internal", "pos_out"):
        setattr(plan, name, empty)
    plan.const_vals = np.zeros(0, dtype=np.uint64)
    plan.arith_c0, plan.arith_c1 = (rng.integers(0, gl.P, size=n - width, dtype=np.uint64)
                                    for _ in range(2))
    plan.arith_m0, plan.arith_m1, plan.arith_a = (
        np.ascontiguousarray(np.concatenate(col), dtype=np.int64) for col in (m0, m1, a))
    plan.arith_out = np.arange(width, n, dtype=np.int64)
    values = np.zeros(n, dtype=np.uint64)
    values[:width] = rng.integers(0, gl.P, size=width, dtype=np.uint64)
    known = np.zeros(n, dtype=bool)
    known[:width] = True
    return plan, values, known


def test_two_threads_at_once_get_the_serial_arrays():
    """Two Python threads run a plan over and over, together: every run
    gives the serial arrays, and while one holds the pool the other runs
    alone."""
    plan, values, known = _chain(np.random.default_rng(5), 20000, 16)
    want_v, want_k = values.copy(), known.copy()
    assert native.run_witness_plan(want_v, want_k, plan, max_threads=1)[0] == 0
    start = threading.Barrier(2)
    runs = {0: [], 1: []}

    def caller(k):
        start.wait()
        for _ in range(12):
            v, kn = values.copy(), known.copy()
            code, err = native.run_witness_plan(v, kn, plan)
            runs[k].append((code, int(err[4]), v.tobytes() == want_v.tobytes(),
                            kn.tobytes() == want_k.tobytes()))

    threads = [threading.Thread(target=caller, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    every = runs[0] + runs[1]
    assert len(every) == 24
    assert all(code == 0 and same_v and same_k for code, _, same_v, same_k in every)
    assert {n for _, n, _, _ in every} <= {1, POOL}
    if POOL > 1:
        assert any(n == 1 for _, n, _, _ in every)
        assert any(n == POOL for _, n, _, _ in every)


@pytest.fixture(scope="module")
def leaf():
    c = WormholeCircuit(CircuitConfig.standard_recursion_zk_config())
    data = c.build_circuit()
    pw = wit.PartialWitness()
    fill_all_targets(tfix.synthetic_circuit_inputs(), pw, c.targets())
    return data, pw


@pytest.fixture(scope="module")
def chunk(leaf):
    """The (2, 1) chunk circuit over two copies of dummy_proof_zk.bin."""
    data, _ = leaf
    with open(os.path.join(ROOT, "generated-bins", "dummy_proof_zk.bin"), "rb") as f:
        child = ProofWithPublicInputs.from_bytes(f.read(), data.common)
    circuit = tagg._build_chunk_circuit_uncached(data.common, 2)
    pw = wit.PartialWitness()
    rec.set_verifier_data_target(pw, circuit.verifier_data_target, data.verifier_only)
    for pt in circuit.proof_targets:
        rec.set_proof_with_pis_target(pw, pt, child)
    return circuit.data, pw


def test_a_plan_of_few_splittable_items_splits_none():
    """Wide batches of 2,000 and 777 arith items in a plan: below the
    plan's floor, no mark, and the run keeps to the caller's thread."""
    s = Synthetic(np.random.default_rng(2))
    s.arith(2000)
    s.poseidon(24)
    s.arith(777)
    plan, pw = s.plan(), s.witness()
    assert wit._native_plan_for(plan).batch_table[:, 5].tolist() == [0, 0, 0]
    serial, pooled = _run(plan, pw, 1), _run(plan, pw, 0)
    assert pooled[2] == 0 and pooled[3][4:7].tolist() == [1, 0, 2801]
    assert serial[0].tobytes() == pooled[0].tobytes()


def test_the_leaf_splits_no_batch(leaf):
    """The leaf's two splittable batches (arith, 7,301 items) are under
    the plan's floor, and no Poseidon batch of it is 16 wide."""
    data, _ = leaf
    table = wit._native_plan_for(data.prover_only.plan).batch_table
    assert not table[:, 5].any()
    assert ((table[:, 0] == 4) & (table[:, 2] >= wit.SPLIT_MIN_POSEIDON)).sum() == 0


@pytest.mark.parametrize("case", ["leaf", "chunk"])
def test_a_circuit_gives_the_serial_arrays_through_the_pool(case, leaf, chunk):
    data, pw = {"leaf": leaf, "chunk": chunk}[case]
    plan = data.prover_only.plan
    serial, pooled = _run(plan, pw, 1), _run(plan, pw, 0)
    assert serial[2] == pooled[2] == 0
    assert serial[0].tobytes() == pooled[0].tobytes()
    assert serial[1].tobytes() == pooled[1].tobytes()
    table = wit._native_plan_for(plan).batch_table
    split = int(table[table[:, 5] == 1, 2].sum())
    assert pooled[3][4:7].tolist() == (
        [POOL if split else 1, split if POOL > 1 else 0, int(table[:, 2].sum())])
    if case == "chunk":
        assert ((table[:, 0] == 4) & (table[:, 5] == 1)).any()
        assert split >= wit.SPLIT_MIN_PLAN
    else:
        assert split == 0
