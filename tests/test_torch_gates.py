"""The port's stacked device gate evaluators (eval_constraints_torch of
the arithmetic, Poseidon and bit-decomposition gates) and its
vanishing evaluation (eval_vanishing_torch) against the JAX package's
host evaluation of the same constraints (BaseAlgebra over numpy), on
random wire columns.  Exact equality."""

import numpy as np
import pytest
import torch

from qzk_tpu.plonk import gates as jgates
from qzk_tpu.plonk.gates import BaseAlgebra
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.plonk import gates as tgates

GATES = [
    ("ArithmeticGate", {"num_ops": 20}),
    ("PoseidonGate", {}),
    ("BitDecompGate", {"bits": 32, "num_ops": 2}),
    ("BitDecompGate", {"bits": 5, "num_ops": 13}),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name,kw", GATES, ids=[f"{n}{kw}" for n, kw in GATES])
def test_stacked_constraints_match_host(name, kw, rng):
    M = 48
    wires = rng.integers(0, gl.P, size=(135, M), dtype=np.uint64)
    wires[:, :3] = np.array([0, 1, gl.P - 1], dtype=np.uint64)[None, :]
    consts = rng.integers(0, gl.P, size=(2, M), dtype=np.uint64)
    want = getattr(jgates, name)(**kw).eval_constraints(
        BaseAlgebra(), wires, consts, [np.uint64(0)] * 4
    )
    got = getattr(tgates, name)(**kw).eval_constraints_torch(
        gt.from_u64(wires), gt.from_u64(consts), None
    )
    assert got.shape == (len(want), M)
    assert (gt.to_u64(got) == np.stack([np.broadcast_to(w, (M,)) for w in want])).all()


def test_torch_algebra_runs_the_generic_gates(rng):
    M = 16
    wires = rng.integers(0, gl.P, size=(135, M), dtype=np.uint64)
    consts = rng.integers(0, gl.P, size=(2, M), dtype=np.uint64)
    pi = rng.integers(0, gl.P, size=4, dtype=np.uint64)
    alg = tgates.TorchAlgebra(torch.device("cpu"))
    tw, tc = gt.from_u64(wires), gt.from_u64(consts)
    tpi = [gt.scalar(v) for v in pi]
    for name in ("ConstantGate", "PublicInputGate"):
        want = getattr(jgates, name)().eval_constraints(BaseAlgebra(), wires, consts, list(pi))
        got = getattr(tgates, name)().eval_constraints(alg, tw, tc, tpi)
        for g, w in zip(got, want):
            assert (gt.to_u64(g) == w).all()
    assert int(gt.to_u64(alg.mul_const(1 << 40, gt.scalar(3)))) == (3 << 40) % gl.P
