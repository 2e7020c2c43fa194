"""The port's stacked device gate evaluators (eval_constraints_torch of
the arithmetic, Poseidon and bit-decomposition gates) against the JAX
package's host evaluation of the same constraints (BaseAlgebra over
numpy), and its vanishing evaluation (eval_vanishing_torch) and
permutation stage (DeviceProverContext.zs_stage) against the JAX
package's eval_vanishing_jax and zs stage, on random columns of a small
circuit under the standard config (80 routed wires in chunks of 7: the
ragged last chunk).  Exact equality.  Also: the Poseidon gate's walk runs
no torch arithmetic outside the field ops (on the card, K4 launches)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import qzk_tpu.plonk.builder as jbuilder
import qzk_tpu.plonk.config as jconfig
import qzk_tpu.plonk.witness as jwitness
import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu.plonk import device_prover as jdp
from qzk_tpu.plonk import gates as jgates
from qzk_tpu.plonk import vanishing as jvan
from qzk_tpu.plonk.gates import BaseAlgebra
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import goldilocks_cuda as gc
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.plonk import device_prover as tdp
from qzk_tpu_torch.plonk import gates as tgates
from qzk_tpu_torch.plonk import vanishing as tvan
from test_torch_prover import _build

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


def test_poseidon_gate_runs_no_torch_arithmetic_outside_the_field_ops(monkeypatch, rng):
    """Outside the goldilocks_cuda wrappers the walk only indexes wire
    rows and concatenates; a round is three wrapper calls (its
    constants' add, its constraint rows, mds_full or mds_partial)."""
    M = 8
    wires = gt.from_u64(rng.integers(0, gl.P, size=(135, M), dtype=np.uint64))
    gate = tgates.PoseidonGate()
    want = gate.eval_constraints_torch(wires, None, None)  # fills the constants' cache
    depth, calls = [0], collections.Counter()
    for name in [*gc.FAMILY_OF, "ext_add", "ext_sub"]:
        def wrapped(*args, _f=getattr(gc, name), _name=name, **kw):
            calls[_name] += depth[0] == 0
            depth[0] += 1
            try:
                return _f(*args, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(gc, name, wrapped)
    outside = collections.Counter()

    class Outside(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if depth[0] == 0:
                outside[getattr(func, "__name__", repr(func))] += 1
            return func(*args, **(kwargs or {}))

    with Outside():
        got = gate.eval_constraints_torch(wires, None, None)
    assert torch.equal(got, want)
    assert set(outside) <= {"__getitem__", "cat", "__get__", "device"}, outside
    assert outside["cat"] == 2  # the initial state and the stacked rows
    assert (calls["mds_full"], calls["mds_partial"]) == (8, 22)
    # 7 wrapper calls before round 0, 2 in it, 3 a round after it, 1 after the rounds
    assert sum(calls.values()) == 7 + 2 + 3 * 29 + 1


@pytest.fixture(scope="module")
def circuits():
    """The same small circuit under the standard config, built by either
    package: (JAX circuit data, port circuit data)."""
    jd, _ = _build(jbuilder, jconfig, jwitness)
    td, _ = _build(tbuilder, tconfig, twitness)
    common = td.common
    assert (common.config.num_routed_wires, common.chunk_size, common.num_chunks) == (80, 7, 12)
    return jd, td


def _field(rng, *shape):
    x = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    x.reshape(-1)[:3] = np.array([0, 1, gl.P - 1], dtype=np.uint64)[: x.size]
    return x


def test_eval_vanishing_torch_matches_eval_vanishing_jax(circuits, rng):
    jd, td = circuits
    common = td.common
    nc, n_pp = common.config.num_challenges, common.num_partial_products
    M = 8 * common.degree
    n_sel, n_const = common.num_selectors, common.config.num_constants
    inputs = {
        "x": _field(rng, M), "wires_mat": _field(rng, 135, M), "sel_mat": _field(rng, n_sel, M),
        "const_mat": _field(rng, n_const, M), "sigma_mat": _field(rng, 80, M),
        "zs_at": _field(rng, nc, M), "zs_right": _field(rng, nc, M),
        "partials_at": _field(rng, nc, n_pp, M), "pi_hash": _field(rng, 4),
        "betas": _field(rng, nc), "gammas": _field(rng, nc), "alphas": _field(rng, nc),
        "l1": _field(rng, M), "k_is": np.asarray(common.k_is, dtype=np.uint64),
    }
    got = tvan.eval_vanishing_torch(common, **{k: gt.from_u64(v) for k, v in inputs.items()})
    want = jvan.eval_vanishing_jax(jd.common, **{k: jnp.asarray(v) for k, v in inputs.items()})
    assert len(got) == len(want) == nc
    for g, w in zip(got, want):
        assert (gt.to_u64(g) == np.asarray(w)).all()


def test_zs_stage_matches_the_jax_zs_stage(circuits, rng):
    jd, td = circuits
    N, nc = td.common.degree, td.common.config.num_challenges
    w_routed, betas, gammas = _field(rng, N, 80), _field(rng, nc), _field(rng, nc)
    tctx = tdp.DeviceProverContext(td.common, td.prover_only, torch.device("cpu"))
    got = tctx.zs_stage(gt.from_u64(w_routed), gt.from_u64(betas), gt.from_u64(gammas))
    jctx = jdp.DeviceProverContext(jd.common, jd.prover_only)
    want = jctx._zs_raw(jnp.asarray(w_routed), jnp.asarray(betas), jnp.asarray(gammas), jctx.C)
    assert got.shape == (nc * (1 + td.common.num_partial_products), N)
    assert (gt.to_u64(got) == np.asarray(want)).all()
