"""The port's qp-plonky2 byte formats (qzk_tpu_torch/utils/
plonky2_{compat,write,verify}.py) against the JAX package's, on the
repository's own circuits (the reference's Rust artifacts are not in
the repository, so tests/test_plonky2_compat.py skips whole): on the
square circuit proved by each package, the port's writers give the JAX
package's bytes, its readers give them back, the documented caveats of
the converters hold (TestWriteSideSemantics of that file, on the
port), and the port's plonky2-format verifier derives the JAX
verifier's challenges and fails the emitted proof at the same step
with the same error.  The zk Wormhole proof in that format is pinned in
tests/test_torch_zk.py."""

import dataclasses

import numpy as np
import pytest
import torch

from qzk_tpu.ops import poseidon as jpos
from qzk_tpu.ops.transcript import Challenger as JChallenger
from qzk_tpu.plonk.builder import CircuitBuilder as JBuilder
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.plonk.fri import VerificationError as JVerificationError
from qzk_tpu.plonk.witness import PartialWitness as JPW
from qzk_tpu.utils import plonky2_compat as jpc
from qzk_tpu.utils import plonky2_verify as jpv
from qzk_tpu.utils import plonky2_write as jpw
from qzk_tpu_torch.ops import poseidon as tpos
from qzk_tpu_torch.ops.transcript import Challenger as TChallenger
from qzk_tpu_torch.plonk.builder import CircuitBuilder as TBuilder
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.plonk.fri import VerificationError
from qzk_tpu_torch.plonk.witness import PartialWitness as TPW
from qzk_tpu_torch.utils import plonky2_compat as pc
from qzk_tpu_torch.utils import plonky2_verify as pv
from qzk_tpu_torch.utils import plonky2_write as pw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _emit(builder_cls, config_cls, pw_cls, writer, reader, prove_kw):
    """tests/test_plonky2_compat.py::own_emitted for one package: the
    square circuit proved at x = 5 and emitted in the fork's format.
    Returns data, proof, the written bytes and their reads."""
    builder = builder_cls(config_cls.standard_recursion_config())
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    data = builder.build()
    wit = pw_cls()
    wit.set_target(x, 5)
    proof = data.prove(wit, **prove_kw)
    blobs = {"common": writer.write_common(writer.common_to_p2(data.common))}
    p2c = reader.read_common(blobs["common"])
    blobs["verifier_only"] = writer.write_verifier_only(writer.verifier_only_to_p2(data.verifier_only))
    p2v = reader.read_verifier_only(blobs["verifier_only"])
    blobs["verifier_data"] = writer.write_verifier_data(p2v, p2c)
    blobs["proof"] = writer.write_proof(writer.proof_to_p2(proof, data.common), p2c)
    p2p = reader.read_proof(blobs["proof"], p2c)
    return data, proof, blobs, p2c, p2v, p2p


@pytest.fixture(scope="module")
def jax_emitted():
    return _emit(JBuilder, JConfig, JPW, jpw, jpc, {})


@pytest.fixture(scope="module")
def own_emitted():
    return _emit(TBuilder, TConfig, TPW, pw, pc, {"device": "cpu"})


@pytest.mark.parametrize("kind", ["common", "verifier_only", "verifier_data", "proof"])
def test_writer_bytes_equal_the_jax_package(kind, own_emitted, jax_emitted):
    assert own_emitted[2][kind] == jax_emitted[2][kind]


def test_port_writer_on_the_jax_structures_gives_the_jax_bytes(jax_emitted):
    """The port's writers on what the port's readers make of the JAX
    bytes: write(read(b)) == b across the packages."""
    _, _, blobs, _, _, _ = jax_emitted
    common = pc.read_common(blobs["common"])
    assert pw.write_common(common) == blobs["common"]
    assert pw.write_verifier_only(pc.read_verifier_only(blobs["verifier_only"])) == (
        blobs["verifier_only"])
    vo, embedded = pc.read_verifier_only(blobs["verifier_data"])
    assert pw.write_verifier_data(vo, embedded) == blobs["verifier_data"]
    assert pw.write_proof(pc.read_proof(blobs["proof"], common), common) == blobs["proof"]


def test_own_artifacts_roundtrip(own_emitted):
    """tests/test_plonky2_compat.py::TestWriteSide::test_own_artifacts_roundtrip
    on the port: read(write(x)) == x."""
    data, proof, _, _, _, _ = own_emitted
    p2c = pw.common_to_p2(data.common)
    back_c = pc.read_common(pw.write_common(p2c))
    assert np.array_equal(back_c.k_is, p2c.k_is)
    for f in dataclasses.fields(p2c):
        if f.name != "k_is":
            assert getattr(back_c, f.name) == getattr(p2c, f.name), f.name
    p2v = pw.verifier_only_to_p2(data.verifier_only)
    vo2 = pc.read_verifier_only(pw.write_verifier_only(p2v))
    assert np.array_equal(vo2.constants_sigmas_cap, p2v.constants_sigmas_cap)
    assert np.array_equal(vo2.circuit_digest, p2v.circuit_digest)
    p2p = pw.proof_to_p2(proof, data.common)
    back = pc.read_proof(pw.write_proof(p2p, p2c), p2c)
    assert np.array_equal(back.public_inputs, p2p.public_inputs)
    assert np.array_equal(back.wires_cap, p2p.wires_cap)
    for a, b in zip(p2p.openings.fri_batches(), back.openings.fri_batches()):
        assert np.array_equal(a, b)
    assert np.array_equal(back.fri.final_poly, p2p.fri.final_poly)
    assert back.fri.pow_witness == p2p.fri.pow_witness
    assert len(back.fri.query_rounds) == len(p2p.fri.query_rounds)
    for qa, qb in zip(back.fri.query_rounds, p2p.fri.query_rounds):
        for a, b in zip(qa.initial_leaves, qb.initial_leaves):
            assert np.array_equal(a, b)
        for pa, pb in zip(qa.initial_paths, qb.initial_paths):
            assert len(pa) == len(pb) and all(np.array_equal(a, b) for a, b in zip(pa, pb))
        for a, b in zip(qa.step_evals, qb.step_evals):
            assert np.array_equal(a, b)


def test_trailing_bytes_are_a_format_error_alike(own_emitted, jax_emitted):
    _, _, blobs, p2c, _, _ = own_emitted
    with pytest.raises(pc.Plonky2FormatError, match="trailing bytes") as port_err:
        pc.read_proof(blobs["proof"] + b"\x00", p2c)
    _, _, jblobs, jp2c, _, _ = jax_emitted
    with pytest.raises(jpc.Plonky2FormatError) as jax_err:
        jpc.read_proof(jblobs["proof"] + b"\x00", jp2c)
    assert str(port_err.value) == str(jax_err.value)
    assert issubclass(pc.Plonky2FormatError, ValueError)


# -- the documented caveats of the converters, on the port ---------------------


def _replay(challenger_cls, pos, nc, digest, pi, wires_cap, zs_cap, q_cap, zeta_obs, right_obs):
    ch = challenger_cls()
    ch.observe_elements(digest)
    ch.observe_elements(pos.hash_no_pad(pi))
    ch.observe_cap(wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(zs_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(q_cap)
    zeta = ch.get_extension_challenge()
    ch.observe_elements(zeta_obs)
    ch.observe_elements(right_obs)
    fri_alpha = ch.get_extension_challenge()
    return [np.asarray(c) for c in (betas, gammas, alphas, zeta, fri_alpha)]


def _native_and_emitted(challenger_cls, pos, emitted):
    data, proof, _, _, p2v, p2p = emitted
    nc = data.common.config.num_challenges
    o = proof.proof.openings
    native = _replay(
        challenger_cls, pos, nc, np.asarray(data.verifier_only.circuit_digest),
        proof.public_inputs, proof.proof.wires_cap, proof.proof.zs_partial_cap,
        proof.proof.quotient_cap,
        np.concatenate([o.preprocessed, o.wires, o.zs_partial, o.quotient]).ravel(),
        np.asarray(o.zs_partial_right).ravel())
    zb, gzb = p2p.openings.fri_batches()
    emitted_ch = _replay(
        challenger_cls, pos, nc, p2v.circuit_digest, p2p.public_inputs, p2p.wires_cap,
        p2p.zs_partial_cap, p2p.quotient_cap, zb.ravel(), gzb.ravel())
    return native, emitted_ch


def test_challenges_align_until_openings(own_emitted):
    """Caveat 3's consequence: the emitted proof's transcript equals the
    native one through zeta and diverges at fri_alpha."""
    native, emitted = _native_and_emitted(TChallenger, tpos, own_emitted)
    for n_ch, e_ch in zip(native[:4], emitted[:4]):
        assert np.array_equal(n_ch, e_ch)
    assert not np.array_equal(native[4], emitted[4])


def test_challenges_equal_the_jax_package(own_emitted, jax_emitted):
    """The port's transcript over its own emitted proof gives the JAX
    package's challenges over the JAX emitted proof: all of them up to
    the openings (the proofs are byte-equal, so fri_alpha too)."""
    t_native, t_emitted = _native_and_emitted(TChallenger, tpos, own_emitted)
    j_native, j_emitted = _native_and_emitted(JChallenger, jpos, jax_emitted)
    for t, j in zip(t_native + t_emitted, j_native + j_emitted):
        assert np.array_equal(t, j)


def test_right_openings_dropped(own_emitted):
    data, proof, _, _, _, p2p = own_emitted
    nc = data.common.config.num_challenges
    native_right = np.asarray(proof.proof.openings.zs_partial_right)
    assert native_right.shape[0] == nc * (1 + data.common.num_partial_products)
    assert p2p.openings.zs_next.shape[0] == nc
    assert np.array_equal(p2p.openings.zs_next, native_right[:nc])
    assert native_right.shape[0] - nc == nc * data.common.num_partial_products


def test_emitted_proof_fails_fork_verify_at_pow_as_in_the_jax_package(own_emitted, jax_emitted):
    _, _, _, p2c, p2v, p2p = own_emitted
    with pytest.raises(VerificationError, match="proof-of-work") as port_err:
        pv.verify(p2c, p2v, p2p, strict_fri=False)
    _, _, _, jp2c, jp2v, jp2p = jax_emitted
    with pytest.raises(JVerificationError, match="proof-of-work") as jax_err:
        jpv.verify(jp2c, jp2v, jp2p, strict_fri=False)
    assert str(port_err.value) == str(jax_err.value)


def test_verify_files_fails_alike(own_emitted, jax_emitted, tmp_path):
    paths = {}
    for tag, emitted in (("t", own_emitted), ("j", jax_emitted)):
        blobs = emitted[2]
        for kind in ("common", "verifier_only", "proof"):
            paths[tag, kind] = tmp_path / f"{tag}_{kind}.bin"
            paths[tag, kind].write_bytes(blobs[kind])
    with pytest.raises(VerificationError) as port_err:
        pv.verify_files(*(str(paths["t", k]) for k in ("common", "verifier_only", "proof")))
    with pytest.raises(JVerificationError) as jax_err:
        jpv.verify_files(*(str(paths["j", k]) for k in ("common", "verifier_only", "proof")))
    assert str(port_err.value) == str(jax_err.value)


def test_selector_info_ungrouped(own_emitted):
    p2c = own_emitted[3]
    n = len(p2c.gates)
    assert p2c.selector_indices == list(range(n))
    assert [tuple(g) for g in p2c.selector_groups] == [(i, i + 1) for i in range(n)]
    assert p2c.num_selectors == n


def test_base_sum_emission():
    """Caveat 1: bit_decomp<bits> is emitted as BaseSumGate<2>(bits),
    whose constraint system differs from ours."""
    from qzk_tpu_torch.utils.plonky2_compat import _GATE_PARAM_COUNT
    from qzk_tpu_torch.utils.plonky2_write import _num_constraints

    builder = TBuilder(TConfig.standard_recursion_config())
    x = builder.add_virtual_target()
    builder.range_check(x, 32)
    builder.register_public_input(x)
    data = builder.build()
    bit_gates = [g for g in data.common.gates if g.gid.startswith("bit_decomp<")]
    assert bit_gates
    p2c = pw.common_to_p2(data.common)
    base_sums = [g for g in p2c.gates if g.tag == 2]
    assert len(base_sums) == len(bit_gates)
    assert base_sums[0].params == (bit_gates[0].bits,)
    assert _GATE_PARAM_COUNT[2] == 1
    assert _num_constraints(bit_gates[0], data.common) != bit_gates[0].bits + 1
    assert pw.write_common(p2c) == jpw.write_common(jpw.common_to_p2(_jax_range_check_common()))


def _jax_range_check_common():
    builder = JBuilder(JConfig.standard_recursion_config())
    x = builder.add_virtual_target()
    builder.range_check(x, 32)
    builder.register_public_input(x)
    return builder.build().common


def test_fri_step_evals_bit_reversed(own_emitted):
    from qzk_tpu_torch.utils.plonky2_write import _bit_rev_rows

    _, proof, _, _, _, p2p = own_emitted
    for nq, eq in zip(proof.proof.fri.query_rounds, p2p.fri.query_rounds):
        assert len(nq.steps) == len(eq.step_evals)
        for s, emitted in zip(nq.steps, eq.step_evals):
            native_leaf = np.asarray(s.leaf, dtype=np.uint64)
            assert np.array_equal(emitted, _bit_rev_rows(native_leaf))
            if native_leaf.shape[0] > 2 and not np.array_equal(native_leaf, _bit_rev_rows(native_leaf)):
                assert not np.array_equal(emitted, native_leaf)
