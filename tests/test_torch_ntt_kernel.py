"""K3's plain version (qzk_tpu_torch.ops.ntt_torch.ntt_axis0, which
the wrapper ntt_cuda.ntt_axis0 runs for CPU tensors) against the JAX
package's Pallas kernel _ntt_axis0_pallas in interpret mode, as the JAX
package's own tests run it on the CPU.  Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks as gl
from qzk_tpu.ops import ntt as jntt
from qzk_tpu.ops import ntt_pallas as npal
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import ntt_cuda as nc
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


def _planes(a):
    a = jnp.asarray(np.asarray(a, dtype=np.uint64))
    return (a & np.uint64(0xFFFFFFFF)).astype(jnp.uint32), (a >> np.uint64(32)).astype(jnp.uint32)


@pytest.mark.parametrize("mul_tw", [False, True])
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("log_n", [3, 6, 8])
def test_ntt_axis0_matches_pallas_kernel(log_n, m, mul_tw, rng):
    n = 1 << log_n
    x = _field(rng, (n, m))
    t = _field(rng, (n, m))
    table = npal._stage_tw_table(log_n)
    x_lo, x_hi = _planes(x[jntt.bit_reverse_perm(log_n)])
    tw_lo, tw_hi = _planes(table)
    t_lo, t_hi = _planes(t)
    o_lo, o_hi = npal._ntt_axis0_pallas(
        x_lo, x_hi, tw_lo, tw_hi, t_lo, t_hi, log_n=log_n, mul_tw=mul_tw, interpret=True
    )
    want = npal._join_u32(np.asarray(o_lo), np.asarray(o_hi))
    got = ntp.ntt_axis0(gt.from_u64(x), gt.from_u64(table), gt.from_u64(t) if mul_tw else None)
    assert (gt.to_u64(got) == want).all()


@pytest.mark.parametrize("layout", ["row-major", "transposed"])
def test_ntt_axis0_batched_and_strided(layout, rng):
    """A (B, n, M) batch, row-major or a transposed view as the second
    four-step pass reads it, equals the transform of each (n, M) block;
    the wrapper takes the plain version for CPU tensors."""
    log_n, m = 5, 12
    x = gt.from_u64(_field(rng, (3, 1 << log_n, m)))
    if layout == "transposed":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    table = gt.from_u64(ntp.stage_tw_table(log_n))
    t = gt.from_u64(_field(rng, (1 << log_n, m)))
    got = nc.ntt_axis0(x, table, t)
    for b in range(3):
        assert torch.equal(got[b], ntp.ntt_axis0(x[b].contiguous(), table, t))
        want = jntt.ntt_np(gt.to_u64(x[b]).T).T
        assert (gt.to_u64(got[b]) == gl.mul(want, gt.to_u64(t))).all()
