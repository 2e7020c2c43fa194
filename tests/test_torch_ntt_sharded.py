"""The port's mesh layer (qzk_tpu_torch/parallel/{sharded,kernels,
ntt_sharded}.py) against the JAX package's, on the 8-device CPU mesh
that conftest.py forces for JAX and on meshes of "cpu" shards for the
port, with exact equality: each collective against its jax.lax
namesake inside a shard_map, the fresh-tensor rule on a mesh whose
shards share one device, the distributed NTT against JAX's and the
numpy oracle, and the sharded commit step's cap."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from qzk_tpu.ops import goldilocks_jax as gj
from qzk_tpu.parallel import ntt_sharded as jntt
from qzk_tpu.parallel import sharded as jsharded
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import merkle as mk
from qzk_tpu_torch.ops import ntt as ntt_mod
from qzk_tpu_torch.parallel import kernels, ntt_sharded, sharded

AXIS = "x"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _meshes(d):
    """(the JAX mesh of the first d CPU devices, the port's d-shard CPU
    mesh)."""
    return (JMesh(np.asarray(jax.devices()[:d]), (AXIS,)),
            sharded.make_mesh(d, devices=["cpu"]))


def _jax_collective(jmesh, body, x):
    """body over the axis-0 blocks of x in a shard_map; the result's
    blocks concatenated along axis 0."""
    fn = jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=P(AXIS), out_specs=P(AXIS),
                               check_vma=False))
    return np.asarray(fn(jnp.asarray(x)), dtype=np.uint64)


def _port(blocks):
    return gt.to_u64(sharded.gather(blocks))


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("split_axis, concat_axis", [(1, 0), (1, 1), (1, 2)],
                         ids=["commit_fri_regroup", "four_step_1_6", "four_step_4"])
def test_all_to_all_matches_jax(rng, d, split_axis, concat_axis):
    """The three (split, concat) pairs of the sharded prover: (1, 0) in
    the commit and the FRI regroup, (b, b) and (b, b+1) in the four-step
    NTT (b = 1 batch axis here)."""
    jmesh, mesh = _meshes(d)
    x = rng.integers(0, 1 << 64, size=(2 * d, 3 * d, 5), dtype=np.uint64)
    want = _jax_collective(jmesh, lambda v: jax.lax.all_to_all(
        v, AXIS, split_axis=split_axis, concat_axis=concat_axis, tiled=True), x)
    got = sharded.all_to_all(sharded.shard(x, mesh), mesh, split_axis, concat_axis)
    assert _port(got).shape == want.shape
    np.testing.assert_array_equal(_port(got), want)


@pytest.mark.parametrize("d", [4, 8])
def test_all_gather_ppermute_psum_match_jax(rng, d):
    jmesh, mesh = _meshes(d)
    x = rng.integers(0, 1 << 64, size=(3 * d, 4), dtype=np.uint64)
    blocks = sharded.shard(x, mesh)
    # all_gather(tiled): every shard holds the whole array
    want = _jax_collective(jmesh, lambda v: jax.lax.all_gather(v, AXIS, tiled=True), x)
    got = sharded.all_gather(blocks, mesh)
    np.testing.assert_array_equal(_port(got), want)
    assert all((gt.to_u64(g) == x).all() for g in got)
    # ppermute as the quotient stage's halo: shard i receives shard i+1's block
    perm = [((i + 1) % d, i) for i in range(d)]
    want = _jax_collective(jmesh, lambda v: jax.lax.ppermute(v, AXIS, perm=perm), x)
    np.testing.assert_array_equal(_port(sharded.ppermute(blocks, mesh, perm)), want)
    # a partial permutation: the shards that receive nothing get zeros
    part = [(0, 1), (2, 0)]
    want = _jax_collective(jmesh, lambda v: jax.lax.ppermute(v, AXIS, perm=part), x)
    np.testing.assert_array_equal(_port(sharded.ppermute(blocks, mesh, part)), want)
    # psum of integer counts, as the quotient stage's tail check
    c = rng.integers(0, 1000, size=(d, 1)).astype(np.int64)
    fn = jax.jit(jax.shard_map(lambda v: jax.lax.psum(v, AXIS), mesh=jmesh, in_specs=P(AXIS),
                               out_specs=P(AXIS), check_vma=False))
    want = np.asarray(fn(jnp.asarray(c)))
    got = sharded.psum(list(torch.as_tensor(c).chunk(d)), mesh)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_collectives_return_fresh_tensors_on_a_repeated_device(rng):
    """Four shards on one device: Tensor.to(that device) would be the
    same storage, so every collective must copy.  A write into what a
    shard received must leave every sender's block as it was."""
    mesh = sharded.make_mesh(4, devices=["cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 4
    x = rng.integers(0, gl.P, size=(8, 8), dtype=np.uint64)
    blocks = sharded.shard(x, mesh)
    keep = [b.clone() for b in blocks]
    outs = {
        "all_to_all": sharded.all_to_all(blocks, mesh, 1, 0),
        "all_gather": sharded.all_gather(blocks, mesh),
        "ppermute": sharded.ppermute(blocks, mesh, [((i + 1) % 4, i) for i in range(4)]),
        "psum": sharded.psum(blocks, mesh),
        "replicate": sharded.replicate(blocks[0], mesh),
        "shard": sharded.shard(sharded.gather(blocks), mesh),
    }
    ptrs = {b.untyped_storage().data_ptr() for b in blocks}
    for name, out in outs.items():
        for o in out:
            assert o.untyped_storage().data_ptr() not in ptrs, name
            o.fill_(7)  # an in-place write after the "transfer"
        for b, k in zip(blocks, keep):
            assert torch.equal(b, k), name
    assert (gt.to_u64(sharded.gather(blocks)) == x).all()


@pytest.mark.parametrize("log_n, d", [(8, 2), (10, 4), (12, 8), (9, 8)])
def test_ntt_sharded_matches_jax_and_oracle(rng, log_n, d):
    jmesh, mesh = _meshes(d)
    x = rng.integers(0, gl.P, size=(3, 1 << log_n), dtype=np.uint64)
    want = ntt_mod.ntt_np(x)
    np.testing.assert_array_equal(np.asarray(jntt.ntt_sharded(x, jmesh), dtype=np.uint64), want)
    got = ntt_sharded.ntt_sharded(x, mesh)
    assert len(got) == d and got[0].shape == (3, (1 << log_n) // d)
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(got, axis=-1)), want)


@pytest.mark.parametrize("log_n, d", [(8, 8), (11, 2), (12, 4)])
def test_intt_sharded_matches_jax_and_oracle_and_round_trips(rng, log_n, d):
    jmesh, mesh = _meshes(d)
    x = rng.integers(0, gl.P, size=(2, 1 << log_n), dtype=np.uint64)
    want = ntt_mod.intt_np(x)
    np.testing.assert_array_equal(np.asarray(jntt.intt_sharded(x, jmesh), dtype=np.uint64), want)
    got = ntt_sharded.intt_sharded(x, mesh)
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(got, axis=-1)), want)
    back = ntt_sharded.ntt_sharded(got, mesh)  # from the blocks, no re-shard
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(back, axis=-1)), x)


def test_four_step_block_tables_match_jax():
    for log_a, inverse, log_scale in ((1, False, 0), (3, True, 9), (2, True, 12)):
        np.testing.assert_array_equal(ntt_sharded._dft_matrix(log_a, inverse, log_scale),
                                      jntt._dft_matrix(log_a, inverse, log_scale))
    for log_n, d, inverse in ((8, 8, False), (12, 4, True)):
        np.testing.assert_array_equal(ntt_sharded._twiddle_table(log_n, d, inverse),
                                      jntt._twiddle_table(log_n, d, inverse))


def _single_device_cap(values, rate_bits, cap_height):
    coeffs, lde = kernels.intt_lde_rows(gt.from_u64(values), rate_bits)
    np.testing.assert_array_equal(gt.to_u64(coeffs), ntt_mod.intt_np(values))
    np.testing.assert_array_equal(gt.to_u64(lde),
                                  ntt_mod.coset_lde_np(ntt_mod.intt_np(values), rate_bits))
    return gt.to_u64(mk.build_merkle_levels(lde.T.contiguous(), cap_height)[-1])


def test_train_step_sharded_cap_matches_jax_and_single_device(rng):
    d, rate_bits, cap_height = 8, 3, 4
    jmesh = jsharded.make_mesh(d)
    mesh = sharded.make_mesh(d, devices=["cpu"])
    values = rng.integers(0, gl.P, size=(8, 1 << 6), dtype=np.uint64)
    want = _single_device_cap(values, rate_bits, cap_height)
    jcap = gj.to_u64(jsharded.train_step_sharded(values, rate_bits, cap_height, jmesh))
    np.testing.assert_array_equal(jcap, want)
    cap = sharded.train_step_sharded(values, rate_bits, cap_height, mesh)
    assert cap.shape == (1 << cap_height, 4)
    np.testing.assert_array_equal(gt.to_u64(cap), want)
    # the blocks: row-sharded coefficients and LDE
    coeffs, lde, _ = sharded.commit_sharded(values, rate_bits, cap_height, mesh)
    assert [c.shape for c in coeffs] == [(1, 1 << 6)] * d
    np.testing.assert_array_equal(gt.to_u64(sharded.gather(coeffs)), ntt_mod.intt_np(values))
    np.testing.assert_array_equal(
        gt.to_u64(sharded.gather(lde)), ntt_mod.coset_lde_np(ntt_mod.intt_np(values), rate_bits))


def test_commit_sharded_more_shards_than_cap_entries(rng):
    """d > 2^cap_height: the cap reduction finishes across the shards."""
    d, rate_bits, cap_height = 8, 3, 2
    mesh = sharded.make_mesh(d, devices=["cpu"])
    values = rng.integers(0, gl.P, size=(8, 1 << 5), dtype=np.uint64)
    cap = sharded.train_step_sharded(values, rate_bits, cap_height, mesh)
    np.testing.assert_array_equal(gt.to_u64(cap), _single_device_cap(values, rate_bits, cap_height))


def test_make_mesh_round_robin_and_needs_a_card(monkeypatch):
    mesh = sharded.make_mesh(5, devices=["cpu", "meta"])
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert mesh.size == 5 and sharded.make_mesh(devices=["cpu"] * 3).size == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(4)


def test_ntt_sharded_bench_runs_on_cpu(tmp_path):
    """python3 -m qzk_tpu_torch.benches.ntt_sharded at a small size on
    "cpu" shards: one JSON line under the JAX bench's metric name."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "qzk_tpu_torch.benches.ntt_sharded",
         "--device", "cpu", "--log-n", "10", "--shards", "4"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    (line,) = [json.loads(s) for s in res.stdout.splitlines()]
    assert line["metric"] == "goldilocks_ntt_2pow10_sharded" and line["unit"] == "s"
    assert line["value"] > 0 and line["single_device_s"] > 0
    assert line["shards"] == 4 and line["devices"] == ["cpu"]
    assert line["card"] == "cpu" and line["power_limit"] is None


def test_shapes_that_do_not_split_raise():
    mesh = sharded.make_mesh(4, devices=["cpu"])
    x = np.zeros((2, 1 << 5), dtype=np.uint64)
    with pytest.raises(ValueError, match="does not split"):
        sharded.all_to_all(sharded.shard(x, mesh, axis=1), mesh, split_axis=0, concat_axis=1)
    with pytest.raises(ValueError, match="do not split over 4 shards"):
        sharded.commit_sharded(np.zeros((6, 8), dtype=np.uint64), 3, 4, mesh)
    three = sharded.make_mesh(3, devices=["cpu"])
    blocks = sharded.shard(np.zeros((1, 24), dtype=np.uint64), three, axis=-1)
    with pytest.raises(ValueError, match="power of two"):
        ntt_sharded.four_step_block(blocks, blocks, 5, three, inverse=False)
