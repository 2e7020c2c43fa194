"""The port's artifact layer (qzk_tpu_torch/utils/serialization.py and
the Wormhole session constructors from bytes and files) against the JAX
package's: the common and verifier-only bytes are the JAX package's,
byte for byte, and each package reads the other's; each refuses the
other's prover-only blob before unpickling; the prover-only blob leaves
the prover contexts out, so it is the same before and after a prove; a
reloaded circuit proves the JAX package's bytes on the CPU; and the
port's circuit builder writes the JAX package's common.bin and
verifier.bin (their sha256 pin WORMHOLE_COMMON_BIN_SHA256 and
WORMHOLE_VERIFIER_BIN_SHA256, which chip_smoke.py demands on the
card)."""

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from qzk_tpu.models.wormhole.circuit_builder import generate_circuit_binaries as jgenerate
from qzk_tpu.models.wormhole.prover import WormholeProver as JProver
from qzk_tpu.models.wormhole.verifier import WormholeVerifier as JVerifier
from qzk_tpu.plonk.builder import CircuitBuilder as JBuilder
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.plonk.witness import PartialWitness as JPW
from qzk_tpu.utils import serialization as jser
from qzk_tpu_torch.models.wormhole import circuit_builder as tbuilder_cli
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.prover import WormholeProver as TProver
from qzk_tpu_torch.models.wormhole.verifier import WormholeVerifier as TVerifier
from qzk_tpu_torch.plonk.builder import CircuitBuilder as TBuilder
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.plonk.witness import PartialWitness as TPW
from qzk_tpu_torch.utils import serialization as tser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _hash_circuit(builder_cls, config_cls):
    """tests/test_serialization.py::_small_circuit, for either stack."""
    builder = builder_cls(config_cls.standard_recursion_config())
    x = builder.add_virtual_target()
    h = builder.hash_n_to_hash_no_pad([x, x])
    builder.register_public_inputs(h.elements)
    return builder.build(), x


def _square_circuit(builder_cls, config_cls):
    """The square circuit (x -> x * x), the cheapest to prove on the CPU."""
    builder = builder_cls(config_cls.standard_recursion_config())
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    return builder.build(), x


@pytest.fixture(scope="module")
def hash_circuits():
    return _hash_circuit(JBuilder, JConfig), _hash_circuit(TBuilder, TConfig)


@pytest.fixture(scope="module")
def squares():
    """(jax data, x), (torch data, x) and the JAX proof at x = 5."""
    (jd, jx), (td, tx) = _square_circuit(JBuilder, JConfig), _square_circuit(TBuilder, TConfig)
    jpw = JPW()
    jpw.set_target(jx, 5)
    return (jd, jx), (td, tx), jd.prove(jpw).to_bytes()


def _port_proof(data, x, value=5):
    pw = TPW()
    pw.set_target(x, value)
    return data.prove(pw, device="cpu").to_bytes()


# -- common and verifier-only bytes ----------------------------------------------


@pytest.mark.parametrize("circuit", ["hash", "square"])
def test_common_and_verifier_bytes_equal_the_jax_package(circuit, hash_circuits, squares):
    (jd, _), (td, _) = hash_circuits if circuit == "hash" else squares[:2]
    assert tser.common_to_bytes(td.common) == jser.common_to_bytes(jd.common)
    assert tser.verifier_only_to_bytes(td.verifier_only) == jser.verifier_only_to_bytes(
        jd.verifier_only)
    assert tser.MAGIC_COMMON == jser.MAGIC_COMMON
    assert tser.MAGIC_VERIFIER == jser.MAGIC_VERIFIER


def test_each_package_reads_the_others_common_and_verifier_bytes(hash_circuits):
    (jd, _), (td, _) = hash_circuits
    t_common = tser.common_from_bytes(jser.common_to_bytes(jd.common))
    j_common = jser.common_from_bytes(tser.common_to_bytes(td.common))
    for back, want in ((t_common, td.common), (j_common, jd.common)):
        assert back.config.num_wires == want.config.num_wires
        assert back.config.fri_config.num_query_rounds == want.config.fri_config.num_query_rounds
        assert back.degree_bits == want.degree_bits
        assert [g.gid for g in back.gates] == [g.gid for g in want.gates]
        assert back.num_public_inputs == want.num_public_inputs
        assert np.array_equal(back.k_is, want.k_is)
        assert np.array_equal(back.circuit_digest, want.circuit_digest)
    assert t_common.config == td.common.config
    assert tser.common_to_bytes(t_common) == jser.common_to_bytes(jd.common)
    t_vo = tser.verifier_only_from_bytes(jser.verifier_only_to_bytes(jd.verifier_only))
    j_vo = jser.verifier_only_from_bytes(tser.verifier_only_to_bytes(td.verifier_only))
    for vo in (t_vo, j_vo):
        assert np.array_equal(vo.constants_sigmas_cap, td.verifier_only.constants_sigmas_cap)
        assert np.array_equal(vo.circuit_digest, td.verifier_only.circuit_digest)


def test_gate_from_gid_names_every_gate_alike(hash_circuits):
    (jd, _), (td, _) = hash_circuits
    gids = [g.gid for g in td.common.gates] + ["bit_decomp<32,2>", "constant<2>", "noop"]
    for gid in gids:
        assert tser.gate_from_gid(gid).gid == jser.gate_from_gid(gid).gid == gid
    with pytest.raises(ValueError, match="unknown gate id"):
        tser.gate_from_gid("lookup<1>")


def test_bad_magics_are_rejected():
    with pytest.raises(ValueError, match="Failed to deserialize common"):
        tser.common_from_bytes(b"nope" + bytes(64))
    with pytest.raises(ValueError, match="Failed to deserialize verifier"):
        tser.verifier_only_from_bytes(b"nope" + bytes(64))


# -- the prover-only blob ---------------------------------------------------------


def test_each_package_refuses_the_others_prover_only_blob(squares):
    (jd, _), (td, _), _ = squares
    assert tser.MAGIC_PROVER != jser.MAGIC_PROVER
    with pytest.raises(ValueError, match="Failed to deserialize prover only data"):
        tser.prover_only_from_bytes(jser.prover_only_to_bytes(jd.prover_only))
    with pytest.raises(ValueError, match="Failed to deserialize prover only data"):
        jser.prover_only_from_bytes(tser.prover_only_to_bytes(td.prover_only))


def test_port_refuses_a_jax_blob_without_importing_jax(squares, tmp_path):
    """Handed the JAX package's blob, the port raises on the magic: the
    pickle of qzk_tpu classes is never loaded, so neither jax nor
    qzk_tpu is imported (as on the card, where neither exists)."""
    (jd, _), _, _ = squares
    blob = tmp_path / "prover.bin"
    blob.write_bytes(jser.prover_only_to_bytes(jd.prover_only))
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from qzk_tpu_torch.utils import serialization as ser
        try:
            ser.prover_only_from_bytes(open({str(blob)!r}, "rb").read())
        except ValueError as e:
            print("refused:", e)
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "qzk_tpu"))
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("refused: Failed to deserialize prover only data")


def test_prover_only_blob_leaves_the_context_out(squares):
    """A prove leaves its context (tensors) and the native witness plan
    on the prover data; neither reaches the blob."""
    _, (td, tx), jproof = squares
    before = tser.prover_only_to_bytes(td.prover_only)
    assert _port_proof(td, tx) == jproof
    assert td.prover_only._torch_ctxs
    assert tser.prover_only_to_bytes(td.prover_only) == before
    back = tser.prover_only_from_bytes(before)
    assert not hasattr(back, "_torch_ctxs")
    assert td.prover_only._torch_ctxs  # pickling did not touch the live object


def test_reloaded_circuit_data_proves_the_jax_bytes(squares):
    _, (td, tx), jproof = squares
    blob = tser.circuit_data_to_bytes(td)
    lc, lv, lp = np.frombuffer(blob[:12], dtype="<u4")
    assert blob[12 : 12 + lc] == tser.common_to_bytes(td.common)
    reloaded = tser.circuit_data_from_bytes(blob)
    po, want = reloaded.prover_only, td.prover_only
    for name in ("slot_rows", "slot_cols", "slot_targets", "preprocessed_values",
                 "preprocessed_lde", "sigma_encodings"):
        assert np.array_equal(getattr(po, name), getattr(want, name)), name
    assert _port_proof(reloaded, tx) == jproof
    td.verify(_proof_from(jproof, td.common))


def _proof_from(blob, common):
    from qzk_tpu_torch.plonk.proof import ProofWithPublicInputs

    return ProofWithPublicInputs.from_bytes(blob, common)


# -- the session constructors -----------------------------------------------------


def _bytes_of(data):
    return tser.prover_only_to_bytes(data.prover_only), tser.common_to_bytes(data.common)


def test_prover_from_bytes_and_files_prove_the_jax_bytes_on_the_cpu(squares, tmp_path):
    """new_from_bytes / new_from_files on device="cpu", on the square
    circuit (the Wormhole targets they rebuild go unused): its witness
    is set directly, and the proof is the JAX package's."""
    _, (td, tx), jproof = squares
    prover_bytes, common_bytes = _bytes_of(td)
    (tmp_path / "prover.bin").write_bytes(prover_bytes)
    (tmp_path / "common.bin").write_bytes(common_bytes)
    made = [
        TProver.new_from_bytes(prover_bytes, common_bytes, device="cpu"),
        TProver.new_from_files(tmp_path / "prover.bin", tmp_path / "common.bin", device="cpu"),
    ]
    for prover in made:
        assert prover.device == "cpu" and prover._targets is not None
        prover.partial_witness.set_target(tx, 5)
        assert prover.prove().to_bytes() == jproof


def test_prover_from_bytes_raises_without_a_card_unless_cpu_is_asked(squares, monkeypatch):
    _, (td, tx), _ = squares
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prover = TProver.new_from_bytes(*_bytes_of(td))
    prover.partial_witness.set_target(tx, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover.prove()


def test_verifier_from_bytes_and_files_accept_the_jax_proof(squares, tmp_path):
    (jd, _), (td, _), jproof = squares
    (tmp_path / "verifier.bin").write_bytes(jser.verifier_only_to_bytes(jd.verifier_only))
    (tmp_path / "common.bin").write_bytes(jser.common_to_bytes(jd.common))
    for verifier in (
        TVerifier.new_from_bytes(jser.verifier_only_to_bytes(jd.verifier_only),
                                 jser.common_to_bytes(jd.common)),
        TVerifier.new_from_files(tmp_path / "verifier.bin", tmp_path / "common.bin"),
    ):
        verifier.verify(_proof_from(jproof, verifier.circuit_data.common))


# -- the Wormhole artifacts: circuit_builder and the default constructor ------------


@pytest.fixture(scope="module")
def wormhole_bins(tmp_path_factory):
    """The JAX package's and the port's generate_circuit_binaries (the
    port's through its command line)."""
    jdir, tdir = tmp_path_factory.mktemp("jax_bins"), tmp_path_factory.mktemp("torch_bins")
    jgenerate(jdir, include_prover_data=True)
    tbuilder_cli.main([str(tdir)])
    return jdir, tdir


def test_circuit_builder_writes_the_jax_common_and_verifier_bins(wormhole_bins):
    jdir, tdir = wormhole_bins
    for name, pin in (("common.bin", tfix.WORMHOLE_COMMON_BIN_SHA256),
                      ("verifier.bin", tfix.WORMHOLE_VERIFIER_BIN_SHA256)):
        jax_bytes = (jdir / name).read_bytes()
        assert hashlib.sha256(jax_bytes).hexdigest() == pin
        assert (tdir / name).read_bytes() == jax_bytes
    assert (tdir / "prover.bin").read_bytes()[:5] == tser.MAGIC_PROVER


def test_each_package_resumes_from_the_others_wormhole_bins(wormhole_bins):
    jdir, tdir = wormhole_bins
    tv = TVerifier.new_from_files(jdir / "verifier.bin", jdir / "common.bin")
    jv = JVerifier.new_from_files(tdir / "verifier.bin", tdir / "common.bin")
    assert tv.circuit_data.common.degree_bits == jv.circuit_data.common.degree_bits == 13
    assert np.array_equal(tv.circuit_data.verifier_only.constants_sigmas_cap,
                          jv.circuit_data.verifier_only.constants_sigmas_cap)
    prover = TProver.new_from_files(tdir / "prover.bin", tdir / "common.bin", device="cpu")
    assert not prover.circuit_data.common.config.zero_knowledge
    assert len(prover.circuit_data.prover_only.rows) == 1 << 13
    with pytest.raises(ValueError, match="Failed to deserialize prover only data"):
        TProver.new_from_files(jdir / "prover.bin", jdir / "common.bin", device="cpu")
    with pytest.raises(ValueError, match="Failed to deserialize prover only data"):
        JProver.new_from_files(tdir / "prover.bin", tdir / "common.bin")


def test_default_builds_the_zk_circuit_when_the_bins_are_the_jax_packages(
        wormhole_bins, tmp_path, monkeypatch):
    jdir, _ = wormhole_bins
    (tmp_path / "generated-bins").mkdir()
    for name in ("prover.bin", "common.bin"):
        (tmp_path / "generated-bins" / name).write_bytes((jdir / name).read_bytes())
    monkeypatch.chdir(tmp_path)
    loads = []
    real_loads = tser.pickle.loads
    monkeypatch.setattr(tser.pickle, "loads", lambda b: loads.append(len(b)) or real_loads(b))
    prover = TProver.default(device="cpu")
    assert loads == []
    assert prover.circuit_data.common.config.zero_knowledge
    assert prover.device == "cpu"


@pytest.mark.skipif(
    os.environ.get("QZK_SLOW_TESTS") != "1",
    reason="the port's full Wormhole prove on the CPU takes minutes; set QZK_SLOW_TESTS=1",
)
def test_port_proof_from_files_on_cpu_matches_pinned_hash(wormhole_bins):
    _, tdir = wormhole_bins
    prover = TProver.new_from_files(tdir / "prover.bin", tdir / "common.bin", device="cpu")
    proof = prover.commit(tfix.synthetic_circuit_inputs()).prove()
    assert hashlib.sha256(proof.to_bytes()).hexdigest() == tfix.WORMHOLE_NONZK_PROOF_SHA256
    TVerifier.new_from_files(tdir / "verifier.bin", tdir / "common.bin").verify(proof)
