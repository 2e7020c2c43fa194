"""The Wormhole circuit under CircuitConfig.standard_recursion_zk_config(),
the config of the repository's headline benchmark (bench.py): both
stacks build the same circuit, and the sha256 of qzk_tpu's zk proof of
synthetic_circuit_inputs() pins qzk_tpu_torch's WORMHOLE_ZK_PROOF_SHA256,
the hash that chip_smoke.py and benches/prove.py demand of the port's
proof on the card.  A file of its own, so that the JAX prove (about
40 s on the CPU) gets a test worker of its own."""

import hashlib
import os

import pytest
import torch

import fixtures as jfix
from qzk_tpu.models.wormhole.circuit import WormholeCircuit as JCircuit
from qzk_tpu.models.wormhole.prover import WormholeProver as JProver
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit as TCircuit
from qzk_tpu_torch.models.wormhole.prover import WormholeProver as TProver
from qzk_tpu_torch.models.wormhole.verifier import WormholeVerifier as TVerifier
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_build():
    c = JCircuit(JConfig.standard_recursion_zk_config())
    return c.build_circuit(), c.targets()


@pytest.fixture(scope="module")
def torch_build():
    c = TCircuit(TConfig.standard_recursion_zk_config())
    return c.build_circuit(), c.targets()


def test_zk_circuit_digest_cap_and_common_bytes_match(jax_build, torch_build):
    jd, td = jax_build[0], torch_build[0]
    assert td.common.config.zero_knowledge and jd.common.config.zero_knowledge
    assert (td.common.circuit_digest == jd.common.circuit_digest).all()
    assert (
        td.verifier_only.constants_sigmas_cap == jd.verifier_only.constants_sigmas_cap
    ).all()
    assert common_to_bytes(td.common) == common_to_bytes(jd.common)
    # every row is used (padding rows are noop gates), so the zk prove
    # draws no blind block: only the three salts
    assert len(td.prover_only.rows) == td.common.degree == 1 << 13


def test_jax_zk_proof_pins_the_port_constant(jax_build):
    data, targets = jax_build
    cfg = JConfig.standard_recursion_zk_config()
    prover = JProver(cfg, _circuit_data=data.prover_data(), _targets=targets)
    proof = prover.commit(jfix.synthetic_circuit_inputs()).prove()
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    assert digest == tfix.WORMHOLE_ZK_PROOF_SHA256


@pytest.mark.skipif(
    os.environ.get("QZK_SLOW_TESTS") != "1",
    reason="the port's full zk Wormhole prove on the CPU takes minutes; set QZK_SLOW_TESTS=1",
)
def test_port_zk_proof_on_cpu_matches_pinned_hash(torch_build):
    data, targets = torch_build
    cfg = TConfig.standard_recursion_zk_config()
    prover = TProver(cfg, _circuit_data=data.prover_data(), _targets=targets, device="cpu")
    proof = prover.commit(tfix.synthetic_circuit_inputs()).prove()
    assert hashlib.sha256(proof.to_bytes()).hexdigest() == tfix.WORMHOLE_ZK_PROOF_SHA256
    TVerifier.new(cfg, data.verifier_data()).verify(proof)
