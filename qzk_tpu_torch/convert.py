"""Carry a circuit built by the JAX package across to this package.

``from_jax_circuit_data(data)`` turns a ``qzk_tpu`` ``CircuitData`` into
this package's ``CircuitData``: the same config, gates, witness plan,
preprocessed polynomials and Merkle tree, so that one build can be
proved by both stacks.  It reads attributes and numpy arrays only and
imports nothing of ``qzk_tpu``: each object is rebuilt from this
package's class of the same name.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .ops import merkle as mk
from .plonk import builder as builder_mod
from .plonk import circuit_data as cd
from .plonk import config as config_mod
from .plonk import gates as gates_mod
from .plonk import witness as witness_mod


def _rebuild(obj, module):
    """The dataclass of `module` with obj's class name and field values."""
    cls = getattr(module, type(obj).__name__)
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _u64(a) -> np.ndarray:
    return np.array(a, dtype=np.uint64, copy=True)


def _config(cfg) -> config_mod.CircuitConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(config_mod.CircuitConfig)}
    fields["fri_config"] = _rebuild(cfg.fri_config, config_mod)
    return config_mod.CircuitConfig(**fields)


def from_jax_circuit_data(data) -> cd.CircuitData:
    """qzk_tpu CircuitData -> qzk_tpu_torch CircuitData."""
    common, po, vo = data.common, data.prover_only, data.verifier_only
    gates = {}

    def gate(g):
        if g.gid not in gates:
            gates[g.gid] = _rebuild(g, gates_mod)
        return gates[g.gid]

    new_common = cd.CommonCircuitData(
        config=_config(common.config),
        degree_bits=int(common.degree_bits),
        gates=[gate(g) for g in common.gates],
        num_public_inputs=int(common.num_public_inputs),
        k_is=_u64(common.k_is),
        circuit_digest=_u64(common.circuit_digest),
    )
    tree = po.preprocessed_tree
    new_po = cd.ProverOnlyCircuitData(
        rows=[
            builder_mod.GateInstance(gate=gate(r.gate), constants=list(r.constants))
            for r in po.rows
        ],
        slot_rows=np.array(po.slot_rows, copy=True),
        slot_cols=np.array(po.slot_cols, copy=True),
        slot_targets=np.array(po.slot_targets, copy=True),
        plan=witness_mod.GeneratorBatches(
            batches=copy.deepcopy(po.plan.batches),
            num_targets=int(po.plan.num_targets),
            roots=np.array(po.plan.roots, copy=True),
        ),
        public_inputs=list(po.public_inputs),
        preprocessed_values=_u64(po.preprocessed_values),
        preprocessed_lde=_u64(po.preprocessed_lde),
        preprocessed_tree=mk.MerkleTree(
            leaves=_u64(tree.leaves),
            levels=[_u64(lv) for lv in tree.levels],
            cap_height=int(tree.cap_height),
        ),
        sigma_encodings=_u64(po.sigma_encodings),
    )
    new_vo = cd.VerifierOnlyCircuitData(
        constants_sigmas_cap=_u64(vo.constants_sigmas_cap),
        circuit_digest=_u64(vo.circuit_digest),
    )
    return cd.CircuitData(common=new_common, prover_only=new_po, verifier_only=new_vo)
