"""The recursion layer of the port (qzk_tpu_torch/plonk/recursion.py)
against the JAX package's, on the square test circuit: both build the
same branching-1 chunk circuit over it, fill the same witness from the
same child proof, fail alike on a tampered child, and the sha256 of
the JAX package's chunk proof pins SQUARE_CHUNK_PROOF_SHA256, the hash
that chip_smoke.py demands of the port's chunk proof on the card.  The
port serializes the chunk circuit to the JAX package's common and
verifier-only bytes, and each package refuses the other's chunk-cache
blob.  Every test here runs with QZK_CIRCUIT_CACHE_DIR="": no disk
cache of either package writes into the checkout."""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from qzk_tpu.models.wormhole import aggregator as jagg
from qzk_tpu.plonk import recursion as jrec
from qzk_tpu.plonk import witness as jwit
from qzk_tpu.plonk.builder import CircuitBuilder as JBuilder
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.utils import serialization as jser
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.plonk import recursion as trec
from qzk_tpu_torch.plonk import witness as twit
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.plonk.proof import ProofWithPublicInputs as TProof
from qzk_tpu_torch.utils import serialization as tser


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def no_chunk_disk_cache():
    """Both packages write chunk circuits to .cache/ unless told not to."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", "")
        yield


def _jax_square():
    builder = JBuilder(JConfig.standard_recursion_config())
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    return builder.build(), x


@pytest.fixture(scope="module")
def squares():
    """((jax data, x), (torch data, x)) of the square circuit."""
    return _jax_square(), tfix.square_circuit(TConfig.standard_recursion_config())


@pytest.fixture(scope="module")
def chunks(squares, no_chunk_disk_cache):
    (jd, _), (td, _) = squares
    return (
        jagg._build_chunk_circuit_uncached(jd.common, 1),
        tagg._build_chunk_circuit_uncached(td.common, 1),
    )


@pytest.fixture(scope="module")
def child_proofs(squares):
    """The square proof at x = 5 from each package."""
    (jd, jx), (td, tx) = squares
    jpw = jwit.PartialWitness()
    jpw.set_target(jx, 5)
    tpw = twit.PartialWitness()
    tpw.set_target(tx, 5)
    return jd.prove(jpw), td.prove(tpw, device="cpu")


def test_square_circuits_match(squares):
    (jd, _), (td, _) = squares
    assert (jd.common.circuit_digest == td.common.circuit_digest).all()
    assert (
        jd.verifier_only.constants_sigmas_cap == td.verifier_only.constants_sigmas_cap
    ).all()


def test_square_chunk_circuits_match(chunks):
    jc, tc = chunks
    jcom, tcom = jc.data.common, tc.data.common
    assert tcom.degree_bits == jcom.degree_bits == 13
    assert (tcom.circuit_digest == jcom.circuit_digest).all()
    assert (
        tc.data.verifier_only.constants_sigmas_cap
        == jc.data.verifier_only.constants_sigmas_cap
    ).all()
    assert [repr(g) for g in tcom.gates] == [repr(g) for g in jcom.gates]
    assert common_to_bytes(tcom) == common_to_bytes(jcom)
    assert len(tc.data.prover_only.rows) == len(jc.data.prover_only.rows)
    assert tcom.num_public_inputs == jcom.num_public_inputs == 1


def test_square_chunk_serialized_bytes_match(chunks):
    jc, tc = chunks
    assert tser.common_to_bytes(tc.data.common) == jser.common_to_bytes(jc.data.common)
    assert tser.verifier_only_to_bytes(tc.data.verifier_only) == jser.verifier_only_to_bytes(
        jc.data.verifier_only)


def test_each_package_refuses_the_others_chunk_blob(chunks):
    """Refused on the magic, before the blob's pickles are loaded."""
    jc, tc = chunks
    with pytest.raises(ValueError, match="bad chunk-circuit cache blob"):
        tagg._chunk_circuit_from_bytes(jagg._chunk_circuit_to_bytes(jc))
    with pytest.raises(ValueError, match="bad chunk-circuit cache blob"):
        jagg._chunk_circuit_from_bytes(tagg._chunk_circuit_to_bytes(tc))


def test_square_child_proofs_are_byte_equal(child_proofs):
    jp, tp = child_proofs
    assert tp.to_bytes() == jp.to_bytes()
    assert list(tp.public_inputs) == [25]


def _fill(rec, wit, chunk, child_vo, proof):
    pw = wit.PartialWitness()
    rec.set_verifier_data_target(pw, chunk.verifier_data_target, child_vo)
    rec.set_proof_with_pis_target(pw, chunk.proof_targets[0], proof)
    return pw


def test_square_chunk_witness_matches(squares, chunks, child_proofs):
    (jd, _), (td, _) = squares
    jc, tc = chunks
    jp, tp = child_proofs
    jpw = _fill(jrec, jwit, jc, jd.verifier_only, jp)
    tpw = _fill(trec, twit, tc, td.verifier_only, tp)
    assert tpw.values == jpw.values
    jvals, jknown = jwit.run_generators(jc.data.prover_only.plan, jpw)
    tvals, tknown = twit.run_generators(tc.data.prover_only.plan, tpw)
    assert tvals.dtype == jvals.dtype == np.uint64
    assert np.array_equal(tknown, jknown)
    assert np.array_equal(tvals, jvals)
    pis = tc.data.prover_only.plan.roots[np.asarray(tc.data.prover_only.public_inputs)]
    assert list(tvals[pis]) == [25]


def _failure(rec, wit, chunk, child_vo, proof):
    """(stage, exception type name) of the chunk witness on `proof`."""
    pw = _fill(rec, wit, chunk, child_vo, proof)
    try:
        wit.run_generators(chunk.data.prover_only.plan, pw)
    except ValueError as e:
        return "run_generators", type(e).__name__
    return None, None


def test_tampered_child_fails_alike(squares, chunks, child_proofs):
    """A child proof with its public input flipped: the in-circuit
    verifier's copy constraints clash when the witness is generated, in
    both packages (tools/test_recursion_quick.py's negative case)."""
    (jd, _), (td, _) = squares
    jc, tc = chunks
    bad = []
    for proof in child_proofs:
        p = copy.copy(proof)
        p.public_inputs = np.array(proof.public_inputs, copy=True)
        p.public_inputs[0] ^= np.uint64(1)
        bad.append(p)
    want = _failure(jrec, jwit, jc, jd.verifier_only, bad[0])
    got = _failure(trec, twit, tc, td.verifier_only, bad[1])
    assert want == ("run_generators", "WitnessConflict")
    assert got == want


def test_jax_square_chunk_proof_pins_the_port_constant(squares, chunks, child_proofs):
    (jd, _), _ = squares
    jc, tc = chunks
    proof = jagg._prove_chunk(jc, [child_proofs[0]], jd.verifier_only).proof
    blob = proof.to_bytes()
    assert hashlib.sha256(blob).hexdigest() == tfix.SQUARE_CHUNK_PROOF_SHA256
    parsed = TProof.from_bytes(blob, tc.data.common)
    assert parsed.to_bytes() == blob
    tc.data.verify(parsed)


@pytest.mark.skipif(
    os.environ.get("QZK_SLOW_TESTS") != "1",
    reason="the port's chunk prove on the CPU takes minutes; set QZK_SLOW_TESTS=1",
)
def test_port_square_chunk_proof_on_cpu_matches_pinned_hash(squares, chunks, child_proofs):
    _, (td, _) = squares
    _, tc = chunks
    proof = tagg._prove_chunk(tc, [child_proofs[1]], td.verifier_only, "cpu").proof
    assert hashlib.sha256(proof.to_bytes()).hexdigest() == tfix.SQUARE_CHUNK_PROOF_SHA256
    tc.data.verify(proof)
