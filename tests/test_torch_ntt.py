"""The port's batched-row NTT (qzk_tpu_torch.ops.ntt_fourstep: the
four-step intt and coset_lde the prover runs, here on CPU tensors
through K3's plain version) against the JAX package's (qzk_tpu.ops.ntt)
device functions and numpy oracles at log_n 4..10.  Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks as gl
from qzk_tpu.ops import ntt as jntt
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import ntt as tntt
from qzk_tpu_torch.ops import ntt_fourstep as nfs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("log_n", range(4, 11))
def test_intt_and_coset_lde_match_jax(log_n, rng):
    n = 1 << log_n
    rate_bits = 3
    x = rng.integers(0, gl.P, size=(3, n), dtype=np.uint64)
    x[0, :4] = [0, 1, gl.P - 1, 1 << 63]
    tabs_n = jntt.pease_tables(log_n)
    tabs_m = jntt.pease_tables(log_n + rate_bits)
    shift = tntt.powers(gl.GENERATOR, n)

    coeffs = nfs.get_fourstep_cuda_plan(log_n).intt(gt.from_u64(x))
    want_c = np.asarray(jntt.intt_pease(jnp.asarray(x), jnp.asarray(tabs_n["twinv"]), log_n=log_n))
    assert (gt.to_u64(coeffs) == want_c).all()
    assert (want_c == jntt.intt_np(x)).all()

    lde = nfs.coset_lde(coeffs, rate_bits, gt.from_u64(shift))
    want_l = np.asarray(
        jntt.coset_lde_pease(jnp.asarray(want_c), rate_bits, jnp.asarray(shift), jnp.asarray(tabs_m["tw"]))
    )
    assert (gt.to_u64(lde) == want_l).all()
    assert (want_l == jntt.coset_lde_np(want_c, rate_bits)).all()


@pytest.mark.parametrize("log_n", [1, 5, 9])
def test_forward_ntt_matches_oracle(log_n, rng):
    x = rng.integers(0, gl.P, size=(2, 1 << log_n), dtype=np.uint64)
    got = nfs.get_fourstep_cuda_plan(log_n).ntt(gt.from_u64(x))
    want = np.asarray(jntt.ntt_pease(jnp.asarray(x), jnp.asarray(jntt.pease_tables(log_n)["tw"])))
    assert (gt.to_u64(got) == want).all()
    assert (want == jntt.ntt_np(x)).all()
