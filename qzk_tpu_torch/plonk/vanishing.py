"""Vanishing-polynomial evaluation — the single implementation of the
PLONK constraint system, instantiated twice:

  * prover: BaseAlgebra over full LDE-coset vectors (the quotient
    computation — the FLOP-heavy part of proving, SURVEY.md §3.1 step 4)
  * verifier: ExtAlgebra at the single opening point zeta

Term order (normative for the alpha combination):
  1. per gate type (CommonCircuitData.gates order), per constraint:
     selector_g(x) * C_{g,i}(x)
  2. per permutation chunk k: rho_{k+1} * prod(den_k) - rho_k * prod(num_k)
     where rho_0 = Z, rho_{last} = Z(g x), intermediate rho are the
     partial-product columns
  3. L1(x) * (Z(x) - 1)
Each challenge c in 0..num_challenges combines the same term list with
its own alpha_c (and its own Z/partials/beta/gamma in group 2-3).
"""

from __future__ import annotations

import numpy as np


def eval_vanishing(
    common,
    alg,
    x,
    wires,  # indexable: wires[j] -> element
    selectors,  # selectors[s] -> element
    constants,  # constants[c] -> element
    sigmas,  # sigmas[j] -> element
    zs,  # zs[c] -> element (Z_c at x)
    zs_right,  # zs_right[c] -> element (Z_c at g*x)
    partials,  # partials[c][k] -> element
    pi_hash,  # 4 elements
    betas,  # list of ints / field scalars per challenge
    gammas,
    alphas,
    l1,  # element: L1(x)
):
    """Returns [combined_c for c in range(num_challenges)] (NOT divided
    by Z_H)."""
    cfg = common.config
    gate_terms = []
    for s, gate in enumerate(common.gates):
        sel = selectors[s]
        for c in gate.eval_constraints(alg, wires, constants, pi_hash):
            gate_terms.append(alg.mul(sel, c))

    out = []
    num_routed = cfg.num_routed_wires
    chunk = common.chunk_size
    for c in range(cfg.num_challenges):
        beta = alg.lift(betas[c])
        gamma = alg.lift(gammas[c])
        nums = []
        dens = []
        for j in range(num_routed):
            kx = alg.mul(alg.const(int(common.k_is[j])), x)
            nums.append(alg.add(alg.add(wires[j], alg.mul(beta, kx)), gamma))
            dens.append(
                alg.add(alg.add(wires[j], alg.mul(beta, sigmas[j])), gamma)
            )
        terms = list(gate_terms)
        rhos = [zs[c]] + list(partials[c]) + [zs_right[c]]
        for k in range(common.num_chunks):
            lo = k * chunk
            hi = min(lo + chunk, num_routed)
            num_prod = nums[lo]
            den_prod = dens[lo]
            for j in range(lo + 1, hi):
                num_prod = alg.mul(num_prod, nums[j])
                den_prod = alg.mul(den_prod, dens[j])
            terms.append(
                alg.sub(
                    alg.mul(rhos[k + 1], den_prod),
                    alg.mul(rhos[k], num_prod),
                )
            )
        terms.append(alg.mul(l1, alg.sub(zs[c], alg.one())))

        alpha = alg.lift(alphas[c])
        acc = alg.zero()
        for t in reversed(terms):
            acc = alg.add(alg.mul(acc, alpha), t)
        out.append(acc)
    return out


def eval_vanishing_torch(
    common,
    x,  # (M,) coset points, device
    wires_mat,  # (135, M)
    sel_mat,  # (n_sel, M)
    const_mat,  # (n_const, M)
    sigma_mat,  # (80, M)
    zs_at,  # list per challenge, (M,)
    zs_right,
    partials_at,
    pi_hash,  # (4,) device
    betas,  # (num_challenges,) device
    gammas,
    alphas,
    l1,  # (M,)
    k_is,  # (80,) device
):
    """Stacked device twin of eval_vanishing: identical term order and
    field semantics, but constraints evaluate as (n_cons, M) matrices
    (gates with eval_constraints_torch) and the alpha combination is a
    powers-dot instead of a Horner chain (the JAX package's
    eval_vanishing_jax, step for step)."""
    import torch

    from ..ops import goldilocks_cuda as gt
    from .gates import TorchAlgebra

    cfg = common.config
    alg = TorchAlgebra(x.device)
    pi_list = [pi_hash[i] for i in range(4)]
    gate_stacks = []
    for s, gate in enumerate(common.gates):
        if hasattr(gate, "eval_constraints_torch"):
            cons = gate.eval_constraints_torch(wires_mat, const_mat, pi_list)
        else:
            rows = gate.eval_constraints(alg, wires_mat, const_mat, pi_list)
            if not rows:
                continue
            cons = torch.stack([r.expand(x.shape) for r in rows])
        gate_stacks.append(gt.mul(sel_mat[s][None, :], cons))
    gate_terms = torch.cat(gate_stacks) if gate_stacks else None

    num_routed = cfg.num_routed_wires
    chunk = common.chunk_size
    w_routed = wires_mat[:num_routed]
    kx = gt.mul(k_is[:, None], x[None, :])  # (80, M)

    def chunk_products(vals):
        """(80, M) -> per-chunk products [(M,)]: one launch, the last
        chunk ragged (exact associativity: identical values to the
        sequential order)."""
        t = gt.prod_chunks(vals, 0, chunk)
        return [t[k] for k in range(common.num_chunks)]

    # every challenge's terms: the gate terms, a permutation term a chunk
    # and the L1 term; the alphas' powers in one launch
    n_terms = (0 if gate_terms is None else gate_terms.shape[0]) + common.num_chunks + 1
    apows_all = gt.powers_vec_multi(alphas, n_terms)
    out = []
    for c in range(cfg.num_challenges):
        beta, gamma = betas[c], gammas[c]
        nums = gt.add(gt.add(w_routed, gt.mul(beta, kx)), gamma)
        dens = gt.add(gt.add(w_routed, gt.mul(beta, sigma_mat)), gamma)
        rhos = [zs_at[c]] + list(partials_at[c]) + [zs_right[c]]
        num_prods = chunk_products(nums)
        den_prods = chunk_products(dens)
        perm_terms = []
        for k in range(common.num_chunks):
            perm_terms.append(
                gt.sub(
                    gt.mul(rhos[k + 1], den_prods[k]),
                    gt.mul(rhos[k], num_prods[k]),
                )
            )
        l1_term = gt.mul(l1, gt.sub(zs_at[c], alg.one()))
        tail = torch.stack(perm_terms + [l1_term])
        terms = (
            torch.cat([gate_terms, tail]) if gate_terms is not None else tail
        )
        out.append(gt.dot_mod(terms, apows_all[c][:, None], axis=0))
    return out
