"""The slice end to end on a small circuit that exercises every gate
type (arithmetic, Poseidon, bit decomposition, constants, public
inputs): the port (qzk_tpu_torch) builds and proves it on device="cpu",
where its device pipeline runs the kernels' plain torch versions, and
the proof bytes must equal the JAX package's default CPU prove, under
the non-zk config and under zero knowledge (salted leaves from the
threefry blinding stream).  The same holds when the port proves the
circuit built by qzk_tpu, carried across by
qzk_tpu_torch.convert.from_jax_circuit_data."""

import copy
import hashlib
import json

import numpy as np
import pytest
import torch

import qzk_tpu.plonk.builder as jbuilder
import qzk_tpu.plonk.config as jconfig
import qzk_tpu.plonk.witness as jwitness
import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.benches.prove import time_proves
from qzk_tpu_torch.convert import from_jax_circuit_data
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.plonk.fri import VerificationError
from qzk_tpu_torch.plonk.prover import PhaseTimer, blinding_seed, blinding_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _build(builder_mod, config_mod, witness_mod, zk=False):
    """tests/test_device_prover.py::_build, for either stack."""
    cfg = config_mod.CircuitConfig.standard_recursion_config().with_zero_knowledge(zk)
    builder = builder_mod.CircuitBuilder(cfg)
    xs = [builder.add_virtual_target() for _ in range(4)]
    h = builder.hash_n_to_hash_no_pad(xs)
    builder.register_public_inputs(h.elements)
    for x in xs:
        builder.range_check(x, 32)
    y = builder.mul(xs[0], xs[1])
    z = builder.add(y, xs[2])
    builder.register_public_input(z)
    data = builder.build()
    pw = witness_mod.PartialWitness()
    for i, x in enumerate(xs):
        pw.set_target(x, 1000 + i)
    return data, pw


@pytest.fixture(scope="module")
def jax_side():
    data, pw = _build(jbuilder, jconfig, jwitness)
    return data, data.prove(pw)


def _cheap_pow(data):
    """A first PoW batch of 2^6 candidates on the CPU: the prove grinds
    on the host in small batches, with the same bytes
    (tests/test_torch_fused.py::test_pow_batch_miss_takes_the_host_grind)."""
    dp.get_context(data.common, data.prover_only, "cpu").pow_batch = 1 << 6


@pytest.fixture(scope="module")
def torch_side():
    """The port's proof and phases."""
    data, pw = _build(tbuilder, tconfig, twitness)
    _cheap_pow(data)
    timer = PhaseTimer()
    proof = data.prove(pw, device="cpu", timer=timer)
    return data, proof, timer


def test_build_matches_jax(jax_side, torch_side):
    jdata, tdata = jax_side[0], torch_side[0]
    assert (tdata.common.circuit_digest == jdata.common.circuit_digest).all()
    assert (
        tdata.verifier_only.constants_sigmas_cap
        == jdata.verifier_only.constants_sigmas_cap
    ).all()
    assert common_to_bytes(tdata.common) == common_to_bytes(jdata.common)


def test_proof_bytes_match_jax(jax_side, torch_side):
    assert torch_side[1].to_bytes() == jax_side[1].to_bytes()


def test_proof_from_converted_circuit_data_matches(jax_side):
    jdata, jproof = jax_side
    data = from_jax_circuit_data(jdata)
    _, pw = _build(tbuilder, tconfig, twitness)
    proof = data.prove(pw, device="cpu")
    assert proof.to_bytes() == jproof.to_bytes()
    data.verify(proof)


def test_port_verifier_accepts_and_rejects(torch_side, jax_side):
    data, proof, _ = torch_side
    data.verify(proof)
    jax_side[0].verify(proof)  # the JAX package's verifier agrees
    proof.public_inputs = proof.public_inputs.copy()
    good = proof.public_inputs[0]
    proof.public_inputs[0] = np.uint64((int(good) + 1) % gl.P)
    try:
        with pytest.raises(VerificationError):
            data.verify(proof)
    finally:
        proof.public_inputs[0] = good


def test_timer_sees_every_phase(torch_side):
    names = [name for name, _ in torch_side[2].results()]
    assert names == [
        "witness", "fused pipeline (device, 1 dispatch)", "PoW finalize (host)",
        "FRI queries (in-dispatch gathers)",
    ]


@pytest.fixture(scope="module")
def zk_sides():
    jdata, jpw = _build(jbuilder, jconfig, jwitness, zk=True)
    tdata, tpw = _build(tbuilder, tconfig, twitness, zk=True)
    _cheap_pow(tdata)
    timer = PhaseTimer()
    tproof = tdata.prove(tpw, device="cpu", timer=timer)
    return jdata, jdata.prove(jpw), tdata, tpw, tproof, timer


def test_zero_knowledge_timer_sees_the_blinding_phase(zk_sides):
    assert [name for name, _ in zk_sides[5].results()] == [
        "witness", "blinding", "fused pipeline (device, 1 dispatch)", "PoW finalize (host)",
        "FRI queries (in-dispatch gathers)",
    ]


def test_zero_knowledge_proof_bytes_match_jax(zk_sides):
    jdata, jproof, tdata, _, tproof, _ = zk_sides
    assert tdata.common.config.zero_knowledge
    assert tproof.to_bytes() == jproof.to_bytes()
    tdata.verify(tproof)
    jdata.verify(tproof)


def test_zero_knowledge_salts_reach_the_query_openings(zk_sides):
    """Each wires, zs and quotient leaf opens with its four salt words,
    which are rows of the salts the blinding stream drew (in the order
    wires, zs, quotient); the preprocessed leaves carry none."""
    _, _, tdata, tpw, tproof, _ = zk_sides
    common = tdata.common
    values, _ = twitness.run_generators(tdata.prover_only.plan, tpw)
    draw = blinding_stream(blinding_seed(values), "cpu")
    salts = [draw((common.lde_size, 4)).numpy().view(np.uint64) for _ in range(3)]
    widths = [common.num_preprocessed_polys, common.config.num_wires + 4,
              common.num_zs_partial_products_polys + 4, common.num_quotient_polys + 4]
    for rnd in tproof.proof.fri.query_rounds:
        assert [len(leaf) for leaf in rnd.initial.leaves] == widths
        for leaf, salt in zip(rnd.initial.leaves[1:], salts):
            assert (salt == leaf[-4:]).all(axis=1).any()


def test_zero_knowledge_flipped_salt_word_is_rejected(zk_sides):
    _, _, tdata, _, tproof, _ = zk_sides
    bad = copy.deepcopy(tproof)
    leaf = bad.proof.fri.query_rounds[0].initial.leaves[1]
    leaf[-1] = np.uint64((int(leaf[-1]) + 1) % gl.P)
    with pytest.raises(VerificationError):
        tdata.verify(bad)


def test_proof_hash_is_stable(torch_side):
    """Proving twice gives the same bytes (the prover is deterministic
    in non-zk mode, and the device context is reused)."""
    data, proof, _ = torch_side
    _, pw = _build(tbuilder, tconfig, twitness)
    again = data.prove(pw, device="cpu")
    assert hashlib.sha256(again.to_bytes()).digest() == hashlib.sha256(proof.to_bytes()).digest()


def test_bench_prove_timing_function_on_the_small_circuit(torch_side):
    """benches/prove.py's timing function: one warm-up and `runs` timed
    proves, the seconds and the last proof's sha256."""
    data, proof, _ = torch_side
    _, pw = _build(tbuilder, tconfig, twitness)
    rec = time_proves(lambda: data.prove(pw, device="cpu"), torch.device("cpu"), runs=2)
    assert rec.pop("proof").to_bytes() == proof.to_bytes()
    assert sorted(rec) == ["median_s", "min_s", "runs_s", "sha256"]
    assert json.loads(json.dumps(rec)) == rec
    assert len(rec["runs_s"]) == 2 and 0 < rec["min_s"] <= rec["median_s"]
    assert rec["sha256"] == hashlib.sha256(proof.to_bytes()).hexdigest()
