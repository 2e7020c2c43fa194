"""The Wormhole circuit under CircuitConfig.standard_recursion_config()
built by both stacks: the port's build must give the JAX package's
circuit digest, constants/sigmas cap and common-data bytes; both
witness generators must give the same wire values from
synthetic_circuit_inputs(); and the sha256 of qzk_tpu's proof bytes
pins qzk_tpu_torch's WORMHOLE_NONZK_PROOF_SHA256, the hash that
chip_smoke.py demands of the port's proof on the card.  The port's
serializer writes the JAX package's common and verifier-only bytes of
the circuit, and the example's inputs (models/wormhole/example.py) give
the JAX package's witness."""

import hashlib
import os

import numpy as np
import pytest
import torch

import fixtures as jfix
from qzk_tpu.models.wormhole.circuit import WormholeCircuit as JCircuit
from qzk_tpu.models.wormhole.circuit import fill_all_targets as jfill
from qzk_tpu.models.wormhole.prover import WormholeProver as JProver
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.plonk.witness import PartialWitness as JPW
from qzk_tpu.plonk.witness import run_generators as jrun
from qzk_tpu.models.wormhole.example import build_example_inputs as jexample
from qzk_tpu.utils import serialization as jser
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit as TCircuit
from qzk_tpu_torch.models.wormhole.circuit import fill_all_targets as tfill
from qzk_tpu_torch.models.wormhole.prover import WormholeProver as TProver
from qzk_tpu_torch.models.wormhole.verifier import WormholeVerifier as TVerifier
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.plonk.witness import PartialWitness as TPW
from qzk_tpu_torch.plonk.witness import run_generators as trun
from qzk_tpu_torch.models.wormhole.example import build_example_inputs as texample
from qzk_tpu_torch.utils import serialization as tser


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_build():
    c = JCircuit(JConfig.standard_recursion_config())
    return c.build_circuit(), c.targets()


@pytest.fixture(scope="module")
def torch_build():
    c = TCircuit(TConfig.standard_recursion_config())
    return c.build_circuit(), c.targets()


def test_circuit_digest_cap_and_common_bytes_match(jax_build, torch_build):
    jd, td = jax_build[0], torch_build[0]
    assert (td.common.circuit_digest == jd.common.circuit_digest).all()
    assert (
        td.verifier_only.constants_sigmas_cap == jd.verifier_only.constants_sigmas_cap
    ).all()
    assert common_to_bytes(td.common) == common_to_bytes(jd.common)
    assert td.common.degree_bits == jd.common.degree_bits


def test_synthetic_inputs_match_the_test_fixture():
    j, t = jfix.synthetic_circuit_inputs(), tfix.synthetic_circuit_inputs()
    assert j.public.funding_amount == t.public.funding_amount
    assert bytes(j.public.exit_account) == bytes(t.public.exit_account)
    assert j.private.secret == t.private.secret
    assert j.private.transfer_count == t.private.transfer_count
    assert bytes(j.private.funding_account) == bytes(t.private.funding_account)
    assert bytes(j.private.unspendable_account) == bytes(t.private.unspendable_account)
    assert j.private.storage_proof.proof == t.private.storage_proof.proof
    assert j.private.storage_proof.indices == t.private.storage_proof.indices
    assert bytes(j.public.root_hash) == bytes(t.public.root_hash)
    assert bytes(j.public.nullifier) == bytes(t.public.nullifier)


def test_witness_values_match(jax_build, torch_build):
    (jd, jt), (td, tt) = jax_build, torch_build
    jpw, tpw = JPW(), TPW()
    jfill(jfix.synthetic_circuit_inputs(), jpw, jt)
    tfill(tfix.synthetic_circuit_inputs(), tpw, tt)
    jv, _ = jrun(jd.prover_only.plan, jpw)
    tv, _ = trun(td.prover_only.plan, tpw)
    assert np.array_equal(jv, tv)


def test_serialized_common_and_verifier_bytes_match(jax_build, torch_build):
    jd, td = jax_build[0], torch_build[0]
    assert tser.common_to_bytes(td.common) == jser.common_to_bytes(jd.common)
    assert tser.verifier_only_to_bytes(td.verifier_only) == jser.verifier_only_to_bytes(
        jd.verifier_only)


def test_example_witness_matches(jax_build, torch_build):
    (jd, jt), (td, tt) = jax_build, torch_build
    jin, tin = jexample(), texample()
    assert bytes(tin.public.root_hash) == bytes(jin.public.root_hash)
    assert bytes(tin.public.nullifier) == bytes(jin.public.nullifier)
    assert tin.private.storage_proof.proof == [] and tin.private.storage_proof.indices == []
    jpw, tpw = JPW(), TPW()
    jfill(jin, jpw, jt)
    tfill(tin, tpw, tt)
    jv, jk = jrun(jd.prover_only.plan, jpw)
    tv, tk = trun(td.prover_only.plan, tpw)
    assert np.array_equal(jk, tk)
    assert np.array_equal(jv, tv)


def test_jax_proof_pins_the_port_constant(jax_build):
    data, targets = jax_build
    cfg = JConfig.standard_recursion_config()
    prover = JProver(cfg, _circuit_data=data.prover_data(), _targets=targets)
    proof = prover.commit(jfix.synthetic_circuit_inputs()).prove()
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    assert digest == tfix.WORMHOLE_NONZK_PROOF_SHA256


@pytest.mark.skipif(
    os.environ.get("QZK_SLOW_TESTS") != "1",
    reason="the port's full Wormhole prove on the CPU takes minutes; set QZK_SLOW_TESTS=1",
)
def test_port_proof_on_cpu_matches_pinned_hash(torch_build):
    data, targets = torch_build
    cfg = TConfig.standard_recursion_config()
    prover = TProver(cfg, _circuit_data=data.prover_data(), _targets=targets, device="cpu")
    proof = prover.commit(tfix.synthetic_circuit_inputs()).prove()
    assert hashlib.sha256(proof.to_bytes()).hexdigest() == tfix.WORMHOLE_NONZK_PROOF_SHA256
    TVerifier.new(cfg, data.verifier_data()).verify(proof)
