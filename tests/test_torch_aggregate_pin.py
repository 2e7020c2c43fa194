"""The sha256 of the JAX package's (2, 1) aggregation root over the two
zk Wormhole proofs of aggregation_leaf_inputs() pins qzk_tpu_torch's
AGG_2_1_ZK_ROOT_SHA256, the hash that chip_smoke.py demands of the
port's root on the card; the port's host verifier accepts that root and
parses the two leaves back from it.  A file of its own, so that the JAX
proves (two leaves and a 2^15-row chunk, about two minutes on the CPU)
get a test worker of their own.  Both packages run with
QZK_CIRCUIT_CACHE_DIR="": no chunk-circuit disk cache writes into the
checkout."""

import hashlib

import pytest
import torch

from qzk_tpu.models.wormhole import aggregator as jagg
from qzk_tpu.models.wormhole.circuit import WormholeCircuit as JCircuit
from qzk_tpu.models.wormhole.prover import WormholeProver as JProver
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.utils import codec as jcodec
from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit as TCircuit
from qzk_tpu_torch.models.wormhole.inputs import PublicCircuitInputs
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.plonk.fri import VerificationError
from qzk_tpu_torch.plonk.proof import ProofWithPublicInputs as TProof


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def _no_chunk_disk_cache():
    """build_chunk_circuit would write the (2, 1) chunk circuit's blob
    into the checkout's .cache/."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", "")
        yield


def _jax_leaf_inputs():
    """aggregation_leaf_inputs(), as the JAX package's input objects."""
    import dataclasses

    import fixtures as jfix

    base = jfix.synthetic_circuit_inputs()
    return [
        dataclasses.replace(
            base,
            public=dataclasses.replace(
                base.public, exit_account=jcodec.BytesDigest(bytes([e] * 32))
            ),
        )
        for e in (0x04, 0x05)
    ]


@pytest.fixture(scope="module")
def jax_root():
    cfg = JConfig.standard_recursion_zk_config()
    circuit = JCircuit(cfg)
    targets = circuit.targets()
    data = circuit.build_circuit()
    leaves = [
        JProver(cfg, _circuit_data=data.prover_data(), _targets=targets)
        .commit(inputs).prove()
        for inputs in _jax_leaf_inputs()
    ]
    assert hashlib.sha256(leaves[0].to_bytes()).hexdigest() == tfix.WORMHOLE_ZK_PROOF_SHA256
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", "")
        root = jagg.aggregate_to_tree(
            leaves, data.common, data.verifier_only, jagg.TreeAggregationConfig.new(2, 1)
        )
    return root.proof.to_bytes()


def test_leaf_inputs_match_the_jax_fixture():
    tleaves = tfix.aggregation_leaf_inputs()
    for t, j in zip(tleaves, _jax_leaf_inputs()):
        assert bytes(t.public.exit_account) == bytes(j.public.exit_account)
        assert bytes(t.public.nullifier) == bytes(j.public.nullifier)
        assert bytes(t.public.root_hash) == bytes(j.public.root_hash)
        assert t.public.funding_amount == j.public.funding_amount
    assert bytes(tleaves[0].public.exit_account) == tfix.DEFAULT_EXIT_ACCOUNT


def test_jax_aggregation_root_pins_the_port_constant(jax_root):
    assert hashlib.sha256(jax_root).hexdigest() == tfix.AGG_2_1_ZK_ROOT_SHA256


def test_port_verifier_accepts_the_jax_root(jax_root):
    leaf = TCircuit(TConfig.standard_recursion_zk_config()).build_circuit()
    chunk = tagg.build_chunk_circuit(leaf.common, 2)
    assert chunk.data.common.degree_bits == 15
    root = TProof.from_bytes(jax_root, chunk.data.common)
    assert root.to_bytes() == jax_root
    chunk.data.verify(root)
    parsed = PublicCircuitInputs.try_from_aggregated(root, 16, 2)
    assert [bytes(p.exit_account) for p in parsed] == [bytes([4] * 32), bytes([5] * 32)]
    root.public_inputs[0] ^= 1
    with pytest.raises(VerificationError):
        chunk.data.verify(root)
