"""The port's sharded prover (qzk_tpu_torch/parallel/prover_sharded.py)
against the JAX package's, on CPU meshes: the chain circuit of
tests/test_prover_sharded.py, built by each package, proved by the port
over meshes of 8 and of 4 "cpu" shards, must give the bytes of the JAX
package's sharded proof (8 shards) and of its single-device proof, and
verify.  Also: the stages against JAX's ShardedProverContext on the same
inputs, a bad witness, the precondition fallback, the mesh switches and
the prover-only blob.  The zk chain proof is
tests/test_torch_prover_sharded_zk.py's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import qzk_tpu.plonk.builder as jbuilder
import qzk_tpu.plonk.config as jconfig
import qzk_tpu.plonk.witness as jwitness
import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu import parallel as jparallel
from qzk_tpu.ops import goldilocks_jax as gj
from qzk_tpu.parallel import prover_sharded as jps
from qzk_tpu.parallel import sharded as jsharded
from qzk_tpu_torch import parallel
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.parallel import prover_sharded as ps
from qzk_tpu_torch.parallel import sharded
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.utils import serialization as ser


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def build_chain_circuit(builder_mod, config_mod, zk=False):
    """tests/test_prover_sharded.py::_build_chain_circuit, for either
    package: a mul/add chain with a range check (degree 2^6)."""
    cfg = config_mod.CircuitConfig.standard_recursion_config().with_zero_knowledge(zk)
    builder = builder_mod.CircuitBuilder(cfg)
    x = builder.add_virtual_target()
    cur = x
    for i in range(60):
        cur = builder.mul(cur, x)
        cur = builder.add(cur, builder.constant(i))
    builder.range_check(x, 32)
    builder.register_public_input(cur)
    return builder.build(), x


def witness(witness_mod, x, value=3):
    pw = witness_mod.PartialWitness()
    pw.set_target(x, value)
    return pw


def cpu_mesh(d):
    return sharded.make_mesh(d, devices=["cpu"])


def prove_on_mesh(data, x, mesh, value=3):
    parallel.set_mesh(mesh)
    try:
        return data.prove(witness(twitness, x, value), device="cpu")
    finally:
        parallel.set_mesh(None)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's chain circuit, its single-device proof and its
    proof over the 8-device mesh (whose stage functions
    test_stages_match_jax reuses)."""
    data, x = build_chain_circuit(jbuilder, jconfig)
    single = data.prove(witness(jwitness, x))
    jmesh = jsharded.make_mesh(8)
    jparallel.set_mesh(jmesh)
    try:
        sharded_proof = data.prove(witness(jwitness, x))
    finally:
        jparallel.set_mesh(None)
    return types.SimpleNamespace(data=data, x=x, single=single, sharded=sharded_proof,
                                 mesh=jmesh)


@pytest.fixture(scope="module")
def port_side():
    """The port's chain circuit, its prover-only blob before any prove,
    and its sharded proofs by mesh size, made at first use."""
    data, x = build_chain_circuit(tbuilder, tconfig)
    side = types.SimpleNamespace(data=data, x=x, blob=ser.prover_only_to_bytes(data.prover_only),
                                 proofs={})

    def proof(d):
        if d not in side.proofs:
            before = ps.PROVES["sharded_prove"]
            side.proofs[d] = prove_on_mesh(data, x, cpu_mesh(d))
            assert ps.PROVES["sharded_prove"] == before + 1
        return side.proofs[d]

    side.proof = proof
    return side


def test_chain_circuits_match(jax_side, port_side):
    assert port_side.data.common.degree_bits == 6
    assert (port_side.data.common.circuit_digest == jax_side.data.common.circuit_digest).all()
    assert jax_side.sharded.to_bytes() == jax_side.single.to_bytes()


@pytest.mark.parametrize("d", [8, 4])
def test_sharded_proof_bytes_match_jax(jax_side, port_side, d):
    proof = port_side.proof(d)
    assert proof.to_bytes() == jax_side.single.to_bytes()
    if d == 8:
        assert proof.to_bytes() == jax_side.sharded.to_bytes()
    port_side.data.verify(proof)
    jax_side.data.verify(proof)


def _jput(x, jmesh, spec):
    """x placed as the JAX package's sharded stages hold it."""
    return jax.device_put(gj.from_u64(np.asarray(x, dtype=np.uint64)), NamedSharding(jmesh, spec))


def test_stages_match_jax(jax_side, port_side, rng):
    """commit, zs and quotient of the two ShardedProverContexts on the
    same random inputs at 8 shards, so that a byte drift points at its
    stage; the quotient's tail count of random inputs is nonzero."""
    common = port_side.data.common
    N, M = common.degree, common.lde_size
    jctx = jps.get_sharded_context(jax_side.data.common, jax_side.data.prover_only,
                                   jax_side.mesh)
    mesh = cpu_mesh(8)
    ctx = ps.get_sharded_context(common, port_side.data.prover_only, mesh)
    AX = jps.AXIS

    values = rng.integers(0, gl.P, size=(136, N), dtype=np.uint64)
    jc, jl, jlv, jcap = jctx.commit(values, 135, None, from_coeffs=False)
    c, lv_leaves, levels, cap = ctx.commit(sharded.shard(values, mesh), 135, None, False)
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(c)), gj.to_u64(jc))
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(lv_leaves)), gj.to_u64(jl))
    assert len(levels[0]) == len(jlv)
    for k, jlevel in enumerate(jlv):
        np.testing.assert_array_equal(
            gt.to_u64(sharded.gather([lv[k] for lv in levels])), gj.to_u64(jlevel))
    np.testing.assert_array_equal(cap, jcap)

    w_routed = rng.integers(0, gl.P, size=(N, 80), dtype=np.uint64)
    betas, gammas, alphas = (rng.integers(0, gl.P, size=2, dtype=np.uint64) for _ in range(3))
    jzs = jctx.zs_stage(_jput(w_routed, jctx.mesh, P(AX, None)), jnp.asarray(betas),
                        jnp.asarray(gammas))
    zs = ctx.zs_stage(sharded.shard(w_routed, mesh), betas, gammas)
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(zs, axis=1)), gj.to_u64(jzs))

    num_zs = common.num_zs_partial_products_polys
    wires_t = rng.integers(0, gl.P, size=(M, 135), dtype=np.uint64)
    zs_t = rng.integers(0, gl.P, size=(M, num_zs), dtype=np.uint64)
    pi_hash = rng.integers(0, gl.P, size=4, dtype=np.uint64)
    jrows, jviol = jctx.quotient_stage(
        _jput(wires_t, jctx.mesh, P(AX, None)), _jput(zs_t, jctx.mesh, P(AX, None)),
        pi_hash, betas, gammas, alphas)
    rows, viol = ctx.quotient_stage(sharded.shard(wires_t, mesh), sharded.shard(zs_t, mesh),
                                    pi_hash, betas, gammas, alphas)
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(rows, axis=1)), gj.to_u64(jrows))
    assert viol == jviol > 0
    # the re-shard to rows for the quotient commit
    want = gj.to_u64(jrows).reshape(common.num_quotient_polys, N)
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(ctx.factor_rows_to_row_blocks(rows))),
                                  want)


def test_bad_witness_raises(port_side, monkeypatch):
    """A witness that breaks the range check raises, as in the JAX
    package's test; a wire matrix that breaks a gate fails the sharded
    quotient stage's psum'd tail check."""
    with pytest.raises(ValueError):
        prove_on_mesh(port_side.data, port_side.x, cpu_mesh(4), value=1 << 40)
    real = dp.DeviceProverContext.assemble_wires

    def corrupted(self, values, blind=None):
        wm = real(self, values, blind)
        wm[1, 2] = gt.add(wm[1, 2], torch.ones_like(wm[1, 2]))
        return wm

    monkeypatch.setattr(dp.DeviceProverContext, "assemble_wires", corrupted)
    with pytest.raises(ValueError, match="constraints unsatisfied"):
        prove_on_mesh(port_side.data, port_side.x, cpu_mesh(4))


def test_sixteen_shards_warn_and_prove_single_device(jax_side, port_side, monkeypatch):
    """A 16-shard mesh does not divide the quotient factor (8): both
    packages warn and prove on one device (the port on the mesh's first,
    with a first PoW batch of 2^6 candidates, so that it grinds on the
    host in small batches)."""
    jparallel.set_mesh(types.SimpleNamespace(devices=np.empty(16, dtype=object)))
    try:
        with pytest.warns(RuntimeWarning, match="falling back to the single-device pipeline"):
            jproof = jax_side.data.prove(witness(jwitness, jax_side.x))
    finally:
        jparallel.set_mesh(None)
    assert jproof.to_bytes() == jax_side.single.to_bytes()
    ctx = dp.get_context(port_side.data.common, port_side.data.prover_only, "cpu")
    monkeypatch.setattr(ctx, "pow_batch", 1 << 6)
    before = ps.PROVES["sharded_prove"]
    with pytest.warns(RuntimeWarning, match="falling back to the single-device pipeline"):
        proof = prove_on_mesh(port_side.data, port_side.x, cpu_mesh(16))
    assert ps.PROVES["sharded_prove"] == before
    assert proof.to_bytes() == jax_side.single.to_bytes()


def _fake_common(config_mod, degree_bits, rate_bits, cap_height, factor):
    cfg = config_mod.CircuitConfig(
        max_quotient_degree_factor=factor,
        fri_config=config_mod.FriConfig(rate_bits=rate_bits, cap_height=cap_height))
    return types.SimpleNamespace(config=cfg, degree=1 << degree_bits,
                                 lde_size=1 << (degree_bits + rate_bits))


def test_mesh_preconditions_match_jax(jax_side, port_side):
    cases = [(jax_side.data.common, port_side.data.common)]
    for degree_bits in (0, 1, 2, 3, 6, 13):
        for rate_bits in (2, 3):
            for cap_height in (1, 2, 4):
                for factor in (4, 8):
                    cases.append(tuple(_fake_common(m, degree_bits, rate_bits, cap_height, factor)
                                       for m in (jconfig, tconfig)))
    seen = set()
    for jcommon, tcommon in cases:
        for d in (1, 2, 3, 4, 6, 8, 16, 32):
            want = jps.mesh_preconditions_ok(
                jcommon, types.SimpleNamespace(devices=np.empty(d, dtype=object)))
            assert ps.mesh_preconditions_ok(tcommon, cpu_mesh(d)) == want
            seen.add(want)
    assert seen == {True, False}
    assert ps.mesh_preconditions_ok(port_side.data.common, cpu_mesh(8))
    assert not ps.mesh_preconditions_ok(port_side.data.common, cpu_mesh(16))


def test_set_mesh_none_beats_qzk_shard(monkeypatch):
    monkeypatch.setenv("QZK_SHARD", "4")
    monkeypatch.setattr(parallel, "_active_mesh", None)
    try:
        parallel.set_mesh(None)
        assert parallel.active_mesh() is None
        mesh = cpu_mesh(2)
        parallel.set_mesh(mesh)
        assert parallel.active_mesh() is mesh
        # without set_mesh(None), QZK_SHARD makes a mesh of the cards at
        # first use: none here, and the port never drops to the CPU
        monkeypatch.setattr(parallel, "_active_mesh", None)
        monkeypatch.setattr(parallel, "_explicit_off", False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.active_mesh()
    finally:
        parallel.set_mesh(None)


def test_mesh_decides_the_device(port_side):
    """With a mesh active the device argument must be one of its
    devices: a CPU prove is refused over a mesh of cards."""
    parallel.set_mesh(sharded.Mesh(["cuda:0"] * 4))
    try:
        with pytest.raises(ValueError, match="not a device of the active mesh"):
            port_side.data.prove(witness(twitness, port_side.x), device="cpu")
    finally:
        parallel.set_mesh(None)


def test_prover_only_blob_leaves_out_the_sharded_context(port_side):
    """A prover-only blob written after a sharded prove holds the arrays
    of one written before it, and no prover context."""
    port_side.proof(4)
    po = port_side.data.prover_only
    assert isinstance(getattr(po, "_sharded_ctx", None), ps.ShardedProverContext)
    after = ser.prover_only_from_bytes(ser.prover_only_to_bytes(po))
    before = ser.prover_only_from_bytes(port_side.blob)
    assert not hasattr(after, "_sharded_ctx") and not hasattr(after, "_torch_ctxs")
    assert set(vars(after)) == set(vars(before))
    for name, want in vars(before).items():
        got = getattr(after, name)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        elif name == "preprocessed_tree":
            for g, w in zip(got.levels, want.levels):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(got.leaves, want.leaves)
        elif name in ("public_inputs", "rows"):
            assert len(got) == len(want)
