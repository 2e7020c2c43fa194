"""The zk chain circuit proved by the port's sharded prover over a mesh
of 4 "cpu" shards: its salts, drawn on the first shard's device in the
blinding stream's order and split into point blocks, must give the bytes
of the port's and the JAX package's single-device zk proofs.  (The JAX
package's own sharded zk proof is slow-tier there, and not called here.)
Its own file, so that --dist loadfile gives it a worker."""

import numpy as np
import pytest
import torch

import qzk_tpu.plonk.builder as jbuilder
import qzk_tpu.plonk.config as jconfig
import qzk_tpu.plonk.witness as jwitness
import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.parallel import prover_sharded as ps
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.plonk.fri import VerificationError

from test_torch_prover_sharded import build_chain_circuit, cpu_mesh, prove_on_mesh, witness


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_sharded_zk_proof_matches_single_device(monkeypatch):
    jdata, jx = build_chain_circuit(jbuilder, jconfig, zk=True)
    jproof = jdata.prove(witness(jwitness, jx))
    data, x = build_chain_circuit(tbuilder, tconfig, zk=True)
    assert data.common.config.zero_knowledge
    before = ps.PROVES["sharded_prove"]
    proof = prove_on_mesh(data, x, cpu_mesh(4))
    assert ps.PROVES["sharded_prove"] == before + 1
    assert proof.to_bytes() == jproof.to_bytes()
    # the port's single-device zk proof (a first PoW batch of 2^6
    # candidates: the grind goes on on the host in small batches)
    ctx = dp.get_context(data.common, data.prover_only, "cpu")
    monkeypatch.setattr(ctx, "pow_batch", 1 << 6)
    single = data.prove(witness(twitness, x), device="cpu")
    assert proof.to_bytes() == single.to_bytes()
    data.verify(proof)
    # the salted wires leaf: four salt words, and the verifier sees a flip
    leaf = proof.proof.fri.query_rounds[0].initial.leaves[1]
    assert len(leaf) == data.common.config.num_wires + 4
    leaf[-1] = np.uint64((int(leaf[-1]) + 1) % gl.P)
    with pytest.raises(VerificationError):
        data.verify(proof)
