"""The slice end to end on a small circuit that exercises every gate
type (arithmetic, Poseidon, bit decomposition, constants, public
inputs): the port (qzk_tpu_torch) builds and proves it on device="cpu",
where its device pipeline runs the kernels' plain torch versions, and
the proof bytes must equal the JAX package's default CPU prove.  The
same holds when the port proves the circuit built by qzk_tpu, carried
across by qzk_tpu_torch.convert.from_jax_circuit_data."""

import hashlib

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
from qzk_tpu_torch.convert import from_jax_circuit_data
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.plonk.fri import VerificationError
from qzk_tpu_torch.plonk.prover import PhaseTimer


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


@pytest.fixture(scope="module")
def torch_side():
    data, pw = _build(tbuilder, tconfig, twitness)
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
        "witness", "wires", "zs", "quotient", "openings", "fri input",
        "fri layers + pow", "queries",
    ]


def test_zero_knowledge_raises_instead_of_a_different_proof():
    data, pw = _build(tbuilder, tconfig, twitness, zk=True)
    with pytest.raises(NotImplementedError, match="zk slice"):
        data.prove(pw, device="cpu")


def test_proof_hash_is_stable(torch_side):
    """Proving twice gives the same bytes (the prover is deterministic
    in non-zk mode, and the device context is reused)."""
    data, proof, _ = torch_side
    _, pw = _build(tbuilder, tconfig, twitness)
    again = data.prove(pw, device="cpu")
    assert hashlib.sha256(again.to_bytes()).digest() == hashlib.sha256(proof.to_bytes()).digest()
