"""The plain reference: it accepts the fixture's zk proof (the JAX
package's pinned bytes) and the port's recorded aggregation root under
the configurations' keys, rejects each with one word changed, and its
generator's hashes give the fixture's public inputs."""

import hashlib
import json
import os

import numpy as np
import pytest

from conftest import DATA, FIXTURE_FIELDS, ROOT
from reference import formats, verify
from reference import withdrawal as W

WORMHOLE_ZK_PROOF_SHA256 = "2a1e822d7e5bb966976f19de117a9b82f5ae47c5465705216c526f48cee518f9"
WORMHOLE_VERIFIER_BIN_SHA256 = "92a22c05785a71f8a351aecb1f02204af0b6574062b7a9f2828476f1da234f73"
# The sha256 of the key bytes (common, verifier) that the JAX package
# builds for the zk Wormhole leaf and for the three chunk circuits of its
# (2, 3) tree (qzk_tpu.models.wormhole.aggregator.build_chunk_circuit over
# each level's common data, written by qzk_tpu.utils.serialization's
# common_to_bytes and verifier_only_to_bytes): a witness of the keys that
# is not the port's build.
JAX_KEY_SHA256 = {
    "wormhole": ("d961baf32e54d2b72defb5c9f68f61130d91148bcd66f960474b60cdc616e532",
                 WORMHOLE_VERIFIER_BIN_SHA256),
    "level1": ("5f37746f5eb49802fd1062c43a95898c09aa63de589685b7a449efe7c72160e5",
               "85ed526b5868643c7005cc2660c75696e3d009310d6f968170d3d2bc6249ad35"),
    "level2": ("cbadc949d7c1c34b763bd6b44aaf5cf31ceaf2eee87141da1942cd545f776aad",
               "d8cb58020d8540d31858ff6ab568e3079b062d23eed38a9d916bcfd392c79ee9"),
    "level3": ("73989de0f8bcff194944e63f1acc1f7f279a53866089fafaf0bb99f24362a485",
               "a21f8ddbfc3d6ef9f962e2736adba21196d1ca371f433aaecbb8a36e659375cb"),
}


def key(config: str, name: str):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        k = json.load(f)["keys"][name]
    return bytes.fromhex(k["common"]), bytes.fromhex(k["verifier"])


FIXTURE = open(os.path.join(DATA, "wormhole_zk_fixture_proof.bin"), "rb").read()
JAX_ROOT = open(os.path.join(DATA, "jax_agg_2_1_fixture_root.bin"), "rb").read()
"""The JAX package's (2, 1) aggregation root over its zk Wormhole proofs
of the fixture's withdrawal with exit accounts [4] * 32 and [5] * 32; its
sha256 is the JAX package's pin, a64855c5...cfec."""
JAX_ROOT_SHA256 = "a64855c51ea85e79cab855cf46c990c9233dc474bdbcaf0e5b705fa14496cfec"
ROOT_PROOF = open(os.path.join(DATA, "agg_2x3_seed21_batch0_root.bin"), "rb").read()


def test_keys_parse_and_the_leaf_key_is_the_pinned_one():
    common, verifier = key("wormhole_zk", "wormhole")
    assert hashlib.sha256(verifier).hexdigest() == WORMHOLE_VERIFIER_BIN_SHA256
    c = formats.read_common(common)
    assert (c.degree_bits, c.num_wires, c.lde_bits, c.cap_height, c.num_queries, c.pow_bits,
            c.zero_knowledge) == (13, 135, 16, 4, 28, 16, True)
    assert key("agg_2x3", "wormhole") == (common, verifier)
    for lv, pis in (("level1", 32), ("level2", 64), ("level3", 128)):
        lc = formats.read_common(key("agg_2x3", lv)[0])
        assert (lc.degree_bits, lc.lde_bits, lc.num_public_inputs) == (15, 18, pis)


@pytest.mark.parametrize("config,name", [("wormhole_zk", "wormhole"), ("agg_2x3", "wormhole"),
                                         ("agg_2x3", "level1"), ("agg_2x3", "level2"),
                                         ("agg_2x3", "level3")])
def test_keys_are_the_jax_packages(config, name):
    common, verifier = key(config, name)
    assert (hashlib.sha256(common).hexdigest(),
            hashlib.sha256(verifier).hexdigest()) == JAX_KEY_SHA256[name]


def test_generator_hashes_give_the_fixture_public_inputs():
    with open(os.path.join(ROOT, "benchmark", "traffic", "storage_proof_7.json")) as f:
        t = json.load(f)
    w = W.build_many([W.Fields(**FIXTURE_FIELDS)], [bytes.fromhex(n) for n in t["nodes"]],
                     t["indices"])[0]
    c = formats.read_common(key("wormhole_zk", "wormhole")[0])
    assert np.array_equal(w.public_inputs, formats.read_proof(FIXTURE, c).public_inputs)


def flipped(data: bytes, at: int) -> bytes:
    b = bytearray(data)
    b[at] ^= 1
    return bytes(b)


# byte offsets: a public input, a cap word, an opening, the PoW nonce's
# neighbourhood, a query leaf, a Merkle sibling near the end
WORMHOLE_OFFSETS = [3, 200, 2000, 9000, 20000, 60000, len(FIXTURE) - 40]


def test_the_pinned_proof_verifies_and_every_flip_is_caught():
    assert hashlib.sha256(FIXTURE).hexdigest() == WORMHOLE_ZK_PROOF_SHA256
    common, verifier = key("wormhole_zk", "wormhole")
    c, vk = formats.read_common(common), formats.read_verifier(verifier)
    proofs = [formats.read_proof(FIXTURE, c)]
    for at in WORMHOLE_OFFSETS:
        try:
            proofs.append(formats.read_proof(flipped(FIXTURE, at), c))
        except formats.FormatError:
            proofs.append(None)  # caught as malformed
    reasons = verify.verify_batch(c, vk, [p for p in proofs if p is not None])
    assert reasons[0] is None
    assert all(r is not None for r in reasons[1:])
    assert verify.transcript(c, vk, proofs[:1]).duplexes == 125


def test_a_proof_of_another_key_is_refused():
    common, verifier = key("wormhole_zk", "wormhole")
    c = formats.read_common(common)
    _, other = key("agg_2x3", "level1")
    assert verify.verify_batch(c, formats.read_verifier(other),
                               [formats.read_proof(FIXTURE, c)]) != [None]


def test_the_recorded_root_verifies_and_a_flip_is_caught():
    common, verifier = key("agg_2x3", "level3")
    c, vk = formats.read_common(common), formats.read_verifier(verifier)
    good = formats.read_proof(ROOT_PROOF, c)
    bad = formats.read_proof(flipped(ROOT_PROOF, 30000), c)
    reasons = verify.verify_batch(c, vk, [good, bad])
    assert reasons[0] is None and reasons[1] is not None


@pytest.mark.parametrize("cut", [1, 8, 100])
def test_short_or_long_bytes_are_malformed(cut):
    c = formats.read_common(key("wormhole_zk", "wormhole")[0])
    with pytest.raises(formats.FormatError):
        formats.read_proof(FIXTURE[:-cut], c)
    with pytest.raises(formats.FormatError):
        formats.read_proof(FIXTURE + bytes(cut), c)


def test_the_jax_packages_root_verifies_under_the_first_chunk_key():
    """A root that the JAX package made, not the port, verifies under the
    level1 key with the two leaves' public inputs in order; one word
    changed, it does not."""
    assert hashlib.sha256(JAX_ROOT).hexdigest() == JAX_ROOT_SHA256
    with open(os.path.join(ROOT, "benchmark", "traffic", "storage_proof_7.json")) as f:
        t = json.load(f)
    leaves = W.build_many([W.Fields(**{**FIXTURE_FIELDS, "exit_account": bytes([e] * 32)})
                           for e in (4, 5)], [bytes.fromhex(n) for n in t["nodes"]],
                          t["indices"])
    common, verifier = key("agg_2x3", "level1")
    c, vk = formats.read_common(common), formats.read_verifier(verifier)
    root = formats.read_proof(JAX_ROOT, c)
    assert np.array_equal(root.public_inputs,
                          np.concatenate([w.public_inputs for w in leaves]))
    bad = formats.read_proof(flipped(JAX_ROOT, 40000), c)
    reasons = verify.verify_batch(c, vk, [root, bad])
    assert reasons[0] is None and reasons[1] is not None
