"""The Wormhole circuit under CircuitConfig.standard_recursion_zk_config(),
the config of the repository's headline benchmark (bench.py): both
stacks build the same circuit, and the sha256 of qzk_tpu's zk proof of
synthetic_circuit_inputs() pins qzk_tpu_torch's WORMHOLE_ZK_PROOF_SHA256,
the hash that chip_smoke.py and benches/prove.py demand of the port's
proof on the card.  The artifacts of the zk circuit: the port writes
the JAX package's common and verifier-only bytes, its verifier resumed
from the JAX package's files accepts generated-bins/dummy_proof_zk.bin
(that same proof), and the JAX package's qp-plonky2 bytes of the proof
pin WORMHOLE_ZK_P2_PROOF_SHA256, which the port's writer gives too.  A
file of its own, so that the JAX prove (about 40 s on the CPU) gets a
test worker of its own."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import fixtures as jfix
from qzk_tpu.models.wormhole.circuit import WormholeCircuit as JCircuit
from qzk_tpu.models.wormhole.prover import WormholeProver as JProver
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.plonk.proof import ProofWithPublicInputs as JProof
from qzk_tpu.utils import plonky2_write as jp2w
from qzk_tpu.utils import serialization as jser
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit as TCircuit
from qzk_tpu_torch.models.wormhole.prover import WormholeProver as TProver
from qzk_tpu_torch.models.wormhole.verifier import WormholeVerifier as TVerifier
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.plonk.proof import ProofWithPublicInputs as TProof
from qzk_tpu_torch.utils import plonky2_compat as tp2c
from qzk_tpu_torch.utils import plonky2_write as tp2w
from qzk_tpu_torch.utils import serialization as tser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY_ZK = os.path.join(ROOT, "generated-bins", "dummy_proof_zk.bin")


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


def test_zk_common_and_verifier_bytes_equal_the_jax_package(jax_build, torch_build):
    jd, td = jax_build[0], torch_build[0]
    assert tser.common_to_bytes(td.common) == jser.common_to_bytes(jd.common)
    assert tser.verifier_only_to_bytes(td.verifier_only) == jser.verifier_only_to_bytes(
        jd.verifier_only)


def test_port_verifier_from_the_jax_files_accepts_the_dummy_proof(jax_build, tmp_path):
    jd = jax_build[0]
    (tmp_path / "common.bin").write_bytes(jser.common_to_bytes(jd.common))
    (tmp_path / "verifier.bin").write_bytes(jser.verifier_only_to_bytes(jd.verifier_only))
    verifier = TVerifier.new_from_files(tmp_path / "verifier.bin", tmp_path / "common.bin")
    blob = open(DUMMY_ZK, "rb").read()
    assert hashlib.sha256(blob).hexdigest() == tfix.WORMHOLE_ZK_PROOF_SHA256
    verifier.verify(TProof.from_bytes(blob, verifier.circuit_data.common))


@pytest.fixture(scope="module")
def p2_proofs(jax_build, torch_build):
    """The dummy zk proof in the qp-plonky2 byte format, written by each
    package from its own reading of the proof and its own common data."""
    jd, td = jax_build[0], torch_build[0]
    blob = open(DUMMY_ZK, "rb").read()
    jproof = JProof.from_bytes(blob, jd.common)
    jbytes = jp2w.write_proof(jp2w.proof_to_p2(jproof, jd.common), jp2w.common_to_p2(jd.common))
    tproof = TProof.from_bytes(blob, td.common)
    p2_common = tp2c.read_common(tp2w.write_common(tp2w.common_to_p2(td.common)))
    p2_proof = tp2w.proof_to_p2(tproof, td.common)
    return jbytes, tp2w.write_proof(p2_proof, p2_common), p2_proof, p2_common


def test_jax_plonky2_proof_pins_the_port_constant(p2_proofs):
    assert hashlib.sha256(p2_proofs[0]).hexdigest() == tfix.WORMHOLE_ZK_P2_PROOF_SHA256


def test_port_plonky2_proof_bytes_equal_the_jax_package(p2_proofs, jax_build, torch_build):
    jbytes, tbytes, p2_proof, p2_common = p2_proofs
    assert tbytes == jbytes
    assert tp2w.write_common(tp2w.common_to_p2(torch_build[0].common)) == jp2w.write_common(
        jp2w.common_to_p2(jax_build[0].common))
    back = tp2c.read_proof(tbytes, p2_common)
    assert np.array_equal(back.public_inputs, p2_proof.public_inputs)
    assert np.array_equal(back.wires_cap, p2_proof.wires_cap)
    assert back.fri.pow_witness == p2_proof.fri.pow_witness
    assert tp2w.write_proof(back, p2_common) == tbytes


def test_bench_verify_on_the_dummy_proof(capsys):
    from qzk_tpu_torch.benches import verify as bench

    bench.main(["--device", "cpu", "--runs", "2", "--proof-file", DUMMY_ZK])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "verifier_verify_proof" and rec["sha256"] == tfix.WORMHOLE_ZK_PROOF_SHA256
    assert len(rec["runs_s"]) == 2 and rec["value"] == min(rec["runs_s"])
    assert rec["card"] == "cpu" and rec["device"] == "cpu" and rec["degree_bits"] == 13
    assert rec["common_bytes"] > 0 and rec["verifier_bytes"] > 0
