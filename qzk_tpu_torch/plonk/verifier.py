"""Proof verification (reference analog: VerifierCircuitData::verify,
SURVEY.md §3.2): replay the Fiat-Shamir transcript, check the vanishing
identity at zeta (same eval_vanishing as the prover, instantiated over
the quadratic extension), and verify the batched FRI opening proof
(Merkle membership, fold consistency, PoW, final-polynomial check).

Host-side numpy, milliseconds — mirrors the reference verifier's
no_std-capable profile (it runs inside a Substrate pallet;
reference wormhole/verifier/src/lib.rs:60-63).
"""

from __future__ import annotations

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon as pos
from ..ops.transcript import Challenger
from . import fri as fri_mod
from .fri import VerificationError
from .gates import PyExtAlgebra
from .proof import ProofWithPublicInputs
from .vanishing import eval_vanishing


def verify(common, verifier_only, pwpi: ProofWithPublicInputs) -> None:
    cfg = common.config
    fri_cfg = cfg.fri_config
    proof = pwpi.proof
    N = common.degree

    if len(pwpi.public_inputs) != common.num_public_inputs:
        raise VerificationError(
            f"wrong number of public inputs: expected "
            f"{common.num_public_inputs}, got {len(pwpi.public_inputs)}"
        )
    pi_hash = pos.hash_no_pad(pwpi.public_inputs)

    # -- transcript replay --------------------------------------------------
    challenger = Challenger()
    challenger.observe_elements(verifier_only.circuit_digest)
    challenger.observe_elements(pi_hash)
    challenger.observe_cap(proof.wires_cap)
    betas = challenger.get_n_challenges(cfg.num_challenges)
    gammas = challenger.get_n_challenges(cfg.num_challenges)
    challenger.observe_cap(proof.zs_partial_cap)
    alphas = challenger.get_n_challenges(cfg.num_challenges)
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_extension_challenge()
    o = proof.openings
    for tag, vals in o.batches():
        challenger.observe_elements(vals.ravel())
    fri_alpha = challenger.get_extension_challenge()

    # -- vanishing identity at zeta ----------------------------------------
    # PyExtAlgebra (python-int pairs) instead of numpy scalars: the
    # ~30k-field-op constraint walk drops from ~1 s to ~50 ms, keeping
    # the verifier near the reference's milliseconds-class profile
    # (SURVEY.md §3.2).
    alg = PyExtAlgebra()
    n_sel = common.num_selectors
    n_const = cfg.num_constants
    zpp = common.num_partial_products

    pair = alg.to_pair
    zs = []
    zs_right = []
    partials = []
    for c in range(cfg.num_challenges):
        base = c * (1 + zpp)
        zs.append(pair(o.zs_partial[base]))
        zs_right.append(pair(o.zs_partial_right[base]))
        partials.append(
            [pair(o.zs_partial[base + 1 + k]) for k in range(zpp)]
        )

    # L1(zeta) = (zeta^N - 1) / (N (zeta - 1)); Z_H(zeta) = zeta^N - 1
    zeta_pow_n = gl.ext_exp(zeta, N)
    one = np.array([1, 0], dtype=np.uint64)
    z_h = gl.ext_sub(zeta_pow_n, one)
    denom = gl.ext_mul(
        np.array([N % gl.P, 0], dtype=np.uint64), gl.ext_sub(zeta, one)
    )
    l1 = gl.ext_mul(z_h, fri_mod.ext_inverse_vec(denom[None])[0])

    vanishing_py = eval_vanishing(
        common,
        alg,
        pair(zeta),
        [pair(w) for w in o.wires],
        [pair(s) for s in o.preprocessed[:n_sel]],
        [pair(c_) for c_ in o.preprocessed[n_sel : n_sel + n_const]],
        [pair(s) for s in o.preprocessed[n_sel + n_const :]],
        zs,
        zs_right,
        partials,
        [(int(h), 0) for h in pi_hash],
        betas,
        gammas,
        alphas,
        pair(l1),
    )
    vanishing = [alg.from_pair(v) for v in vanishing_py]

    # recombine quotient chunks: q_c(zeta) = sum_t zeta^{tN} chunk_{c,t}
    zeta_n = zeta_pow_n
    for c in range(cfg.num_challenges):
        acc = np.zeros(2, dtype=np.uint64)
        for t in reversed(range(cfg.max_quotient_degree_factor)):
            acc = gl.ext_mul(acc, zeta_n)
            acc = gl.ext_add(
                acc, o.quotient[c * cfg.max_quotient_degree_factor + t]
            )
        expected = gl.ext_mul(z_h, acc)
        if not np.array_equal(vanishing[c], expected):
            raise VerificationError(
                f"vanishing polynomial identity failed (challenge {c})"
            )

    # -- FRI opening proof --------------------------------------------------
    S = common.num_preprocessed_polys
    n_wires = cfg.num_wires
    n_zs = common.num_zs_partial_products_polys
    n_q = common.num_quotient_polys
    salt = 4 if cfg.zero_knowledge else 0
    # leaf column layout per oracle (salt columns excluded from batches)
    w_pre = S
    w_wires = n_wires + salt
    w_zs = n_zs + salt
    w_quot = n_q + salt
    off_wires = w_pre
    off_zs = off_wires + w_wires
    off_quot = off_zs + w_zs
    zeta_cols = np.concatenate(
        [
            np.arange(S),
            off_wires + np.arange(n_wires),
            off_zs + np.arange(n_zs),
            off_quot + np.arange(n_q),
        ]
    )
    gzeta_cols = off_zs + np.arange(n_zs)

    def reduce_claims(claims):
        fa = alg.to_pair(fri_alpha)
        acc = alg.zero()
        for v in np.asarray(claims, dtype=np.uint64)[::-1]:
            acc = alg.add(alg.mul(acc, fa), (int(v[0]), int(v[1])))
        return alg.from_pair(acc)

    zeta_claims = np.concatenate(
        [o.preprocessed, o.wires, o.zs_partial, o.quotient]
    )
    g = np.uint64(common.subgroup_generator())
    zeta_right = gl.ext_mul(zeta, gl.ext(g, np.uint64(0)))
    batch_spec = [
        (zeta, reduce_claims(zeta_claims), zeta_cols),
        (zeta_right, reduce_claims(o.zs_partial_right), gzeta_cols),
    ]
    caps = [
        verifier_only.constants_sigmas_cap,
        proof.wires_cap,
        proof.zs_partial_cap,
        proof.quotient_cap,
    ]
    fri_mod.fri_verify(
        caps,
        batch_spec,
        proof.fri,
        common.degree_bits,
        common,
        challenger,
        fri_alpha,
    )
