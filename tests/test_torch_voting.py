"""The voting circuit, ported (qzk_tpu_torch.models.voting): under both
configs the port builds the JAX package's circuit and, from the same
inputs, proves the same bytes on device="cpu"; the sha256 of qzk_tpu's
proofs pins VOTING_{NONZK,ZK}_PROOF_SHA256, the hashes chip_smoke.py
demands of the port's proofs on the card; the port verifies its proofs;
and the invalid inputs of tests/test_voting.py fail the same way in
both stacks."""

import hashlib

import numpy as np
import pytest
import torch

import qzk_tpu.models.voting as jvoting
import qzk_tpu.plonk.builder as jbuilder
import qzk_tpu.plonk.config as jconfig
import qzk_tpu.plonk.witness as jwitness
import qzk_tpu_torch.models.voting as tvoting
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu.utils import serialization as jser
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.models.voting import fixtures as tfix
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.plonk.fri import VerificationError
from qzk_tpu_torch.utils import serialization as tser
from test_voting import create_test_inputs as jax_test_inputs

CONFIGS = {
    "nonzk": ("standard_recursion_config", tfix.VOTING_NONZK_PROOF_SHA256),
    "zk": ("standard_recursion_zk_config", tfix.VOTING_ZK_PROOF_SHA256),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_build(cfg):
    builder = jbuilder.CircuitBuilder(cfg)
    targets = jvoting.VoteTargets.new(builder)
    jvoting.VoteCircuitData.circuit(targets, builder)
    return builder.build(), targets


@pytest.fixture(scope="module", params=list(CONFIGS))
def sides(request):
    """(name, jax data, jax proof, torch data, torch targets, torch proof)."""
    name = request.param
    make = CONFIGS[name][0]
    jdata, jtargets = _jax_build(getattr(jconfig.CircuitConfig, make)())
    jpw = jwitness.PartialWitness()
    jax_test_inputs().fill_targets(jpw, jtargets)
    tdata, ttargets = tfix.build_vote_circuit(getattr(tconfig.CircuitConfig, make)())
    tpw = twitness.PartialWitness()
    tfix.create_test_inputs().fill_targets(tpw, ttargets)
    return name, jdata, jdata.prove(jpw), tdata, ttargets, tdata.prove(tpw, device="cpu")


def test_inputs_match_the_test_helper():
    j, t = jax_test_inputs(), tfix.create_test_inputs()
    for field in ("proposal_id", "merkle_root", "nullifier"):
        assert np.array_equal(getattr(j.public_inputs, field), getattr(t.public_inputs, field))
    assert j.public_inputs.vote == t.public_inputs.vote
    assert np.array_equal(j.private_inputs.private_key, t.private_inputs.private_key)
    assert all(np.array_equal(a, b) for a, b in zip(
        j.private_inputs.merkle_siblings, t.private_inputs.merkle_siblings, strict=True))
    assert j.private_inputs.path_indices == t.private_inputs.path_indices
    assert j.private_inputs.actual_merkle_depth == t.private_inputs.actual_merkle_depth
    assert tvoting.MAX_MERKLE_DEPTH == jvoting.MAX_MERKLE_DEPTH


def test_build_matches_jax(sides):
    _, jdata, _, tdata, _, _ = sides
    assert (tdata.common.circuit_digest == jdata.common.circuit_digest).all()
    assert (
        tdata.verifier_only.constants_sigmas_cap == jdata.verifier_only.constants_sigmas_cap
    ).all()
    assert common_to_bytes(tdata.common) == common_to_bytes(jdata.common)
    assert tdata.common.degree_bits == 8


def test_serialized_bytes_match_jax(sides):
    """The port's common and verifier-only bytes are the JAX package's;
    its prover-only blob of the proved circuit carries no context."""
    _, jdata, _, tdata, _, _ = sides
    assert tser.common_to_bytes(tdata.common) == jser.common_to_bytes(jdata.common)
    assert tser.verifier_only_to_bytes(tdata.verifier_only) == jser.verifier_only_to_bytes(
        jdata.verifier_only)
    assert tdata.prover_only._torch_ctxs
    back = tser.prover_only_from_bytes(tser.prover_only_to_bytes(tdata.prover_only))
    assert not hasattr(back, "_torch_ctxs")
    assert np.array_equal(back.preprocessed_lde, tdata.prover_only.preprocessed_lde)


def test_jax_proof_pins_the_port_constant(sides):
    name, _, jproof, _, _, _ = sides
    assert hashlib.sha256(jproof.to_bytes()).hexdigest() == CONFIGS[name][1]


def test_proof_bytes_match_jax(sides):
    _, _, jproof, _, _, tproof = sides
    assert tproof.to_bytes() == jproof.to_bytes()


def test_port_verifies_and_rejects_a_tampered_public_input(sides):
    _, jdata, _, tdata, _, tproof = sides
    tdata.verify(tproof)
    jdata.verify(tproof)
    inputs = tfix.create_test_inputs()
    pis = tproof.public_inputs
    assert len(pis) == 13
    assert (pis[0:4] == inputs.public_inputs.proposal_id).all()
    assert (pis[4:8] == inputs.public_inputs.merkle_root).all()
    assert pis[8] == 1
    assert (pis[9:13] == inputs.public_inputs.nullifier).all()
    good = pis[9]
    tproof.public_inputs = pis.copy()
    tproof.public_inputs[9] = np.uint64((int(good) + 1) % gl.P)
    try:
        with pytest.raises(VerificationError):
            tdata.verify(tproof)
    finally:
        tproof.public_inputs = pis


def _too_deep(inputs):
    inputs.private_inputs.actual_merkle_depth = jvoting.MAX_MERKLE_DEPTH + 1


def _longer_path(inputs):
    inputs.private_inputs.path_indices.append(False)


@pytest.mark.parametrize("spoil", [_too_deep, _longer_path], ids=["depth", "length"])
def test_invalid_fill_gives_the_same_error(spoil):
    errors = []
    for (_, targets), witness_mod, inputs in (
        (_jax_build(jconfig.CircuitConfig.standard_recursion_config()), jwitness,
         jax_test_inputs()),
        (tfix.build_vote_circuit(tconfig.CircuitConfig.standard_recursion_config()), twitness,
         tfix.create_test_inputs()),
    ):
        spoil(inputs)
        with pytest.raises(ValueError) as err:
            inputs.fill_targets(witness_mod.PartialWitness(), targets)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "exceeds maximum allowed depth" in errors[0] or "length mismatch" in errors[0]


def _wrong_depth(inputs):
    inputs.private_inputs.actual_merkle_depth = 1


def _wrong_everything(inputs):
    priv = inputs.private_inputs
    priv.private_key = np.full(4, 12345, dtype=np.uint64)
    priv.merkle_siblings = [np.full(4, 67890, dtype=np.uint64), np.full(4, 11111, dtype=np.uint64)]
    priv.path_indices = [True, True]
    priv.actual_merkle_depth = 2


@pytest.mark.parametrize("spoil", [_wrong_depth, _wrong_everything], ids=["depth", "all"])
def test_invalid_proof_gives_the_same_error(spoil):
    jdata, jtargets = _jax_build(jconfig.CircuitConfig.standard_recursion_config())
    tdata, ttargets = tfix.build_vote_circuit(tconfig.CircuitConfig.standard_recursion_config())
    errors = []
    for data, targets, witness_mod, inputs, kw in (
        (jdata, jtargets, jwitness, jax_test_inputs(), {}),
        (tdata, ttargets, twitness, tfix.create_test_inputs(), {"device": "cpu"}),
    ):
        spoil(inputs)
        pw = witness_mod.PartialWitness()
        inputs.fill_targets(pw, targets)
        with pytest.raises(witness_mod.WitnessConflict) as err:
            data.prove(pw, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
