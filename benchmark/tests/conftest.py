"""The benchmark's own tests.  From the repository's root:

    python -m pytest benchmark/tests -q             # the CPU tests
    python -m pytest benchmark/tests -q -m card     # on a machine with CUDA cards

Tests marked `card` need CUDA cards; each decides in its fixture whether
there are enough, and skips with the reason when there are not."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
DATA = os.path.join(BENCH_DIR, "tests", "data")
sys.path[:0] = [BENCH_DIR, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs CUDA cards (skips without them)")


@pytest.fixture
def cards():
    """The number of CUDA cards; skips the test when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()


FIXTURE_FIELDS = dict(
    secret=bytes.fromhex("4c8587bd422e01d961acdc75e7d66f6761b7af7c9b1864a492f369c9d6724f05"),
    transfer_count=4,
    funding_account=bytes.fromhex(
        "e27ccb09503c7ccda505b2d8c30f95267401ee85b59a6a1129e476b3528de14c"),
    funding_amount=1000000000000,
    exit_account=bytes([4] * 32))
"""The withdrawal that data/wormhole_zk_fixture_proof.bin proves: the
reference's test-helpers defaults (wormhole/tests/test-helpers/src/lib.rs),
exit account [4] * 32.  That file is the zk Wormhole proof whose sha256,
2a1e822d...18f9, the JAX package's prover gives for these inputs."""
