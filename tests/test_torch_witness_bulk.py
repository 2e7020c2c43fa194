"""The partial witness as arrays (qzk_tpu_torch/plonk/witness.py) and the
chunk fill as one array call a proof (plonk/recursion.py), against the
per-value versions they replace, kept here as references: a dict of
Python ints filled one value at a time, and a seed that walks it in set
order.  The cases are the zk Wormhole leaf and the (2, 1) chunk over two
copies of generated-bins/dummy_proof_zk.bin."""

import os
import pickle

import numpy as np
import pytest
import torch

from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit, fill_all_targets
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.plonk import recursion as rec
from qzk_tpu_torch.plonk import witness as wit
from qzk_tpu_torch.plonk.builder import CircuitBuilder
from qzk_tpu_torch.plonk.config import CircuitConfig
from qzk_tpu_torch.plonk.proof import ProofWithPublicInputs
from qzk_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


class DictWitness:
    """The per-value partial witness: a dict of canonical Python ints."""

    def __init__(self):
        self.values = {}

    def set_target(self, t, value):
        value = int(value) % gl.P
        existing = self.values.get(t)
        if existing is not None and existing != value:
            raise wit.WitnessConflict(t)
        self.values[t] = value

    def set_target_arr(self, targets, values):
        values = np.asarray(values, dtype=np.uint64).ravel()
        assert len(targets) == len(values)
        for t, v in zip(targets, values):
            self.set_target(t, int(v))

    def set_hash_target(self, h, digest):
        digest = np.asarray(digest, dtype=np.uint64).ravel()
        assert digest.shape == (4,)
        self.set_target_arr(list(h.elements), digest)

    def set_bool_target(self, b, value):
        self.set_target(b.target, 1 if value else 0)


def dict_seed(plan, pw):
    """The seed as a walk over the dict in set order."""
    values = np.zeros(plan.num_targets, dtype=np.uint64)
    known = np.zeros(plan.num_targets, dtype=bool)
    for t, v in pw.values.items():
        r = plan.roots[t]
        if known[r] and values[r] != np.uint64(v):
            raise wit.WitnessConflict(t)
        values[r] = np.uint64(v)
        known[r] = True
    return values, known


def per_value_fill_proof(pw, proof_t, pwpi):
    """The per-value chunk fill: one set call a digest, extension
    coordinate, leaf or public-input vector."""
    p = pwpi.proof

    def set_caps(cap_ts, cap_vals):
        for d_t, d in zip(cap_ts, np.asarray(cap_vals, dtype=np.uint64)):
            pw.set_hash_target(d_t, d)

    def set_exts(ext_ts, vals):
        vals = np.asarray(vals, dtype=np.uint64).reshape(-1, 2)
        assert len(ext_ts) == len(vals)
        for e, v in zip(ext_ts, vals):
            pw.set_target(e.data[0], int(v[0]))
            pw.set_target(e.data[1], int(v[1]))

    set_caps(proof_t.wires_cap, p.wires_cap)
    set_caps(proof_t.zs_partial_cap, p.zs_partial_cap)
    set_caps(proof_t.quotient_cap, p.quotient_cap)
    o, ot = p.openings, proof_t.openings
    for name in ("preprocessed", "wires", "zs_partial", "quotient", "zs_partial_right"):
        set_exts(getattr(ot, name), getattr(o, name))
    f, ft = p.fri, proof_t.fri
    for cap_t, cap in zip(ft.commit_phase_caps, f.commit_phase_caps):
        set_caps(cap_t, cap)
    set_exts(ft.final_poly, f.final_poly)
    pw.set_target(ft.pow_witness, int(f.pow_witness))
    for rt, r in zip(ft.query_rounds, f.query_rounds):
        for leaf_ts, leaf in zip(rt.initial_leaves, r.initial.leaves):
            pw.set_target_arr(leaf_ts, np.asarray(leaf, dtype=np.uint64))
        for path_ts, path in zip(rt.initial_paths, r.initial.paths):
            for d_t, d in zip(path_ts, path):
                pw.set_hash_target(d_t, d)
        for st, s in zip(rt.steps, r.steps):
            set_exts(st.leaf, s.leaf)
            for d_t, d in zip(st.path, s.path):
                pw.set_hash_target(d_t, d)
    pw.set_target_arr(proof_t.public_inputs, np.asarray(pwpi.public_inputs, dtype=np.uint64))


def per_value_fill_verifier_data(pw, vd_t, verifier_only):
    for d_t, d in zip(vd_t.constants_sigmas_cap,
                      np.asarray(verifier_only.constants_sigmas_cap, dtype=np.uint64)):
        pw.set_hash_target(d_t, d)
    pw.set_hash_target(vd_t.circuit_digest,
                       np.asarray(verifier_only.circuit_digest, dtype=np.uint64))


class Recorder(DictWitness):
    """A per-value witness that also lists each (target, value) it sets,
    in order, and counts the set calls made from outside it."""

    def __init__(self):
        super().__init__()
        self.sets, self.calls, self._inner = [], 0, False

    def _outer(self, method, *args):
        if self._inner:
            return method(self, *args)
        self.calls += 1
        self._inner = True
        try:
            return method(self, *args)
        finally:
            self._inner = False

    def set_target(self, t, value):
        self.sets.append((int(t), int(value) % gl.P))
        self._outer(DictWitness.set_target, t, value)

    def set_target_arr(self, targets, values):
        self._outer(DictWitness.set_target_arr, targets, values)

    def set_hash_target(self, h, digest):
        self._outer(DictWitness.set_hash_target, h, digest)


@pytest.fixture(scope="module")
def leaf():
    """(circuit data, targets) of the zk Wormhole leaf."""
    c = WormholeCircuit(CircuitConfig.standard_recursion_zk_config())
    return c.build_circuit(), c.targets()


@pytest.fixture(scope="module")
def chunk(leaf):
    """(the (2, 1) chunk circuit, the leaf's verifier data, the child)."""
    data, _ = leaf
    with open(os.path.join(ROOT, "generated-bins", "dummy_proof_zk.bin"), "rb") as f:
        child = ProofWithPublicInputs.from_bytes(f.read(), data.common)
    return tagg._build_chunk_circuit_uncached(data.common, 2), data.verifier_only, child


def _fill(case, leaf, chunk, pw, per_value=False):
    """Fill `pw` for `case` ("leaf" or "chunk"); the chunk with the
    per-value fill when asked.  Gives the generator plan."""
    if case == "leaf":
        data, targets = leaf
        fill_all_targets(tfix.synthetic_circuit_inputs(), pw, targets)
        return data.prover_only.plan
    circuit, vo, child = chunk
    fill_vd = per_value_fill_verifier_data if per_value else rec.set_verifier_data_target
    fill_proof = per_value_fill_proof if per_value else rec.set_proof_with_pis_target
    fill_vd(pw, circuit.verifier_data_target, vo)
    for pt in circuit.proof_targets:
        fill_proof(pw, pt, child)
    return circuit.data.prover_only.plan


@pytest.mark.parametrize("case", ["leaf", "chunk"])
def test_bulk_seed_matches_the_dict_walk(case, leaf, chunk):
    """The arrays, filled by the port, hold the per-value fill's values in
    its set order, and their seed is the dict walk's, bit for bit."""
    pw = wit.PartialWitness()
    plan = _fill(case, leaf, chunk, pw)
    ref = DictWitness()
    _fill(case, leaf, chunk, ref, per_value=True)
    assert list(pw.values.items()) == list(ref.values.items())
    assert pw.num_values == len(ref.values)
    values, known = wit.seed_values(plan, pw)
    ref_values, ref_known = dict_seed(plan, ref)
    assert values.dtype == ref_values.dtype == np.uint64
    assert np.array_equal(known, ref_known)
    assert np.array_equal(values, ref_values)


def test_fill_sets_the_per_value_fills_targets_in_order(chunk):
    """The cached target ids of a proof are those the per-value fill sets,
    in its order and number, and the values line up with them; the cache
    stays out of the chunk circuit's pickle."""
    circuit, _, child = chunk
    pt = circuit.proof_targets[1]
    before = pickle.dumps(pt)
    rec_pw = Recorder()
    per_value_fill_proof(rec_pw, pt, child)
    ids, sizes = rec._fill_targets(pt)
    assert rec._fill_targets(pt)[0] is ids
    assert ids.dtype == np.int64 and len(ids) == sum(sizes) == len(rec_pw.sets)
    assert ids.tolist() == [t for t, _ in rec_pw.sets]
    vals = np.concatenate(rec._fill_values(child)) % np.uint64(gl.P)
    assert vals.tolist() == [v for _, v in rec_pw.sets]
    assert pickle.dumps(pt) == before
    assert rec_pw.calls > 1000


def _clash_earlier(pw):
    pw.set_target_arr([3, 4, 5], [30, 40, 50])
    pw.set_target_arr([6, 4, 7, 5], [60, 41, 70, 51])


def _clash_in_call(pw):
    pw.set_target(9, 1)
    pw.set_target_arr([2, 8, 3, 8, 2, 3], [20, 80, 30, 80, 21, 31])


def _equal_mod_p(pw):
    pw.set_target(1, gl.P + 5)
    pw.set_target_arr([1, 2, 2], [5, 7, np.uint64(gl.P + 7)])
    pw.set_target_arr([2, 3], [gl.P + 7, gl.P - 1])


@pytest.mark.parametrize(
    "spoil, target",
    [(_clash_earlier, 4), (_clash_in_call, 2), (_equal_mod_p, None)],
    ids=["earlier-set", "in-call", "equal-mod-p"])
def test_set_target_arr_raises_where_the_loop_does(spoil, target):
    """The same target named, and the places before it set, as the loop
    of set_target calls."""
    outcome = []
    for pw in (wit.PartialWitness(), DictWitness()):
        try:
            spoil(pw)
            err = None
        except wit.WitnessConflict as e:
            err = str(e)
        outcome.append((err, list(pw.values.items())))
    assert outcome[0] == outcome[1]
    if target is None:
        assert outcome[0][0] is None
    else:
        assert outcome[0][0] == f"set twice with different values: target {target}"


def _connected():
    """A circuit with two pairs of connected targets: (a, b), (c, d)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    a, b, c, d = builder.add_virtual_targets(4)
    builder.connect(a, b)
    builder.connect(c, d)
    builder.register_public_input(builder.mul(a, c))
    return builder.build().prover_only.plan, (a, b, c, d)


@pytest.mark.parametrize(
    "order, later",
    [("abcd", "b"), ("bacd", "a"), ("acdb", "d"), ("cadb", "d"), ("cdab", "d")])
def test_seed_names_the_later_set_target_of_a_root(order, later):
    """a and b share a root, as c and d do; a and b clash, and c and d
    too.  The seed names the later set of the first clash in set order,
    as the dict walk does; a target set twice keeps its first place."""
    plan, (a, b, c, d) = _connected()
    ts = dict(zip("abcd", (a, b, c, d)))
    vals = {"a": 1, "b": 2, "c": 3, "d": 4}
    names = []
    for pw in (wit.PartialWitness(), DictWitness()):
        for n in order:
            pw.set_target_arr([ts[n]], [vals[n]])
        pw.set_target(ts[order[0]], vals[order[0]])
        seed = wit.seed_values if isinstance(pw, wit.PartialWitness) else dict_seed
        with pytest.raises(wit.WitnessConflict) as err:
            seed(plan, pw)
        names.append(str(err.value))
    assert names[0] == names[1] == f"set twice with different values: target {ts[later]}"


def test_generators_span_carries_values_and_set_calls(chunk):
    """A chunk's witness.generators span holds the targets seeded and the
    set calls that set them: one a child proof and one for the verifier
    data, against one a digest, coordinate or vector before."""
    class Timer:
        def mark(self, name):
            pass

    pw = wit.PartialWitness()
    plan = _fill("chunk", None, chunk, pw)
    ref = Recorder()
    _fill("chunk", None, chunk, ref, per_value=True)
    timer = Timer()
    with spans.span("prove", timer=timer):
        wit.run_generators(plan, pw)
    gen = [s for s in spans.spans_of(timer) if s.name == "witness.generators"]
    assert len(gen) == 1
    attrs = gen[0].attrs
    assert set(attrs) == {"values", "set_calls", "threads", "split_items", "items"}
    assert (attrs["values"], attrs["set_calls"]) == (len(ref.values), 3)
    assert len(ref.values) == 34442 and ref.calls > 3
