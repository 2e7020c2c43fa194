"""The Poseidon work count of a proof, from shapes and its nonce."""

import json
import os

from conftest import DATA, ROOT
from harness import work
from reference import formats


def common(config, name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        return formats.read_common(bytes.fromhex(json.load(f)["keys"][name]["common"]))


def test_the_fixture_proofs_work():
    c = common("wormhole_zk", "wormhole")
    p = formats.read_proof(open(os.path.join(DATA, "wormhole_zk_fixture_proof.bin"), "rb").read(), c)
    assert p.pow_witness == 64721
    rows = 1 << 16
    trees = rows * (18 + 4 + 3) + 3 * (rows - 16)  # wires 139, zs 28, quotient 20 words a leaf
    fri = 4096 * 4 + (4096 - 16) + 256 * 4 + (256 - 16)
    assert work.duplexes(c) == 125
    perms, nbytes = work.proof_work(c, p.pow_witness)
    assert perms == trees + fri + 125 + 64721 == 1_921_534
    assert nbytes == 8 * (rows * (139 + 28 + 20 + 12) + 3 * 12 * (rows - 16)
                          + 4096 * 36 + 12 * (4096 - 16) + 256 * 36 + 12 * (256 - 16)
                          + 2 * 12 * (125 + 64721))


def test_chunk_circuit_work_and_the_bound():
    c = common("agg_2x3", "level3")
    assert work.duplexes(c) == 133 and c.arities() == [4, 4, 2]
    perms, nbytes = work.proof_work(c, 0)
    rates = {"int_muls_per_s": 64 * 132 * 1.98e9, "bytes_per_s": work.PEAK_BYTES}
    t = work.least_seconds(perms, nbytes, rates)
    assert t == perms * work.INT_MULS_PER_PERM / rates["int_muls_per_s"]  # operations bound
    assert 4e-3 < t < 6e-3
