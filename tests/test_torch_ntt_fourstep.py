"""The port's four-step NTT slice against the JAX package, exact
equality throughout:

- the plain FourStepPlan and the K3 four-step plan (on CPU tensors,
  which run K3's plain version) against FourStepPallasPlan, the JAX
  FourStepPlan and the numpy oracle;
- NTTPlan against the JAX NTTPlan;
- every host table against the JAX package's.

K3's plain version is held against the Pallas kernel in
tests/test_torch_ntt_kernel.py, and the prover's batched-row intt and
coset LDE against the JAX Pease transforms in tests/test_torch_ntt.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks as gl
from qzk_tpu.ops import ntt as jntt
from qzk_tpu.ops import ntt_pallas as npal
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import ntt as tntt
from qzk_tpu_torch.ops import ntt_fourstep as nfs
from qzk_tpu_torch.ops import ntt_torch as ntp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _field(rng, shape):
    """Canonical values with 0, 1 and p-1 planted."""
    x = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    x.reshape(-1)[:3] = [0, 1, gl.P - 1]
    return x


@pytest.mark.parametrize("log_n", [6, 7, 9, 10])
def test_fourstep_matches_jax_and_oracle(log_n, rng):
    x = _field(rng, (1, 1 << log_n))
    want = jntt.ntt_np(x)
    jplan = jntt.get_fourstep_plan(log_n)
    assert (np.asarray(jax.jit(jplan.ntt)(jnp.asarray(x), jnp.asarray(jplan.twiddle))) == want).all()
    pplan = npal.get_fourstep_pallas_plan(log_n)
    got_pallas = pplan.ntt(jnp.asarray(x), jnp.asarray(pplan.twiddle), interpret=True)
    assert (np.asarray(got_pallas) == want).all()
    plain = tntt.get_fourstep_plan(log_n).ntt(gt.from_u64(x))
    assert (gt.to_u64(plain) == want).all()
    k3 = nfs.get_fourstep_cuda_plan(log_n)
    assert (gt.to_u64(k3.ntt(gt.from_u64(x))) == want).all()
    assert (gt.to_u64(k3.ntt(gt.from_u64(x[0]))) == want[0]).all()
    assert (gt.to_u64(k3.intt(gt.from_u64(want))) == x).all()


@pytest.mark.parametrize("log_n", range(1, 11))
def test_radix2_plan_matches_jax(log_n, rng):
    x = _field(rng, (2, 1 << log_n))
    jplan = jntt.get_plan(log_n)
    plan = tntt.get_plan(log_n)
    got = plan.ntt(gt.from_u64(x))
    want = jax.jit(jplan.ntt)(jnp.asarray(x))
    assert (gt.to_u64(got) == np.asarray(want)).all()
    assert (gt.to_u64(plan.intt(got)) == np.asarray(jax.jit(jplan.intt)(want))).all()
    assert (gt.to_u64(plan.intt(got)) == x).all()


@pytest.mark.parametrize("log_n", [1, 6, 7, 13])
def test_fourstep_tables_match_jax(log_n):
    mine, ref = tntt.get_fourstep_plan(log_n), jntt.get_fourstep_plan(log_n)
    assert (mine.log1, mine.log2, mine.n1, mine.n2) == (ref.log1, ref.log2, ref.n1, ref.n2)
    assert (mine.twiddle == ref.twiddle).all()
    assert (mine.rev1 == ref.rev1).all() and (mine.rev2 == ref.rev2).all()
    for a, b in zip(mine.stage_tw1 + mine.stage_tw2, ref.stage_tw1 + ref.stage_tw2, strict=True):
        assert (a == b).all()
    k3 = nfs.get_fourstep_cuda_plan(log_n)
    assert (k3.tw1 == npal._stage_tw_table(ref.log1)).all()
    assert (k3.tw2 == npal._stage_tw_table(ref.log2)).all()


@pytest.mark.parametrize("log_n", [0, 1, 4, 11])
def test_stage_tables_match_pallas(log_n):
    fwd = ntp.stage_tw_table(log_n)
    assert fwd.shape == npal._stage_tw_table(log_n).shape
    assert (fwd == npal._stage_tw_table(log_n)).all()
    inv = ntp.stage_tw_table(log_n, inverse=True)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        assert (gl.mul(fwd[s - 1, :half], inv[s - 1, :half]) == 1).all()


def test_powers_mul_table_matches_jax():
    base = 0x1234567890ABCDEF % gl.P
    for n in (1, 2, 100, 1 << 12):
        assert (tntt.powers_mul_table(base, n) == jntt.powers_mul_table(base, n)).all()
    assert (tntt.powers_mul_table(base, 100) == tntt.powers(base, 100)).all()
