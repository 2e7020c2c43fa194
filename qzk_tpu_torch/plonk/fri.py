"""FRI — batched polynomial-opening proofs (commit / fold / query) and
verification.

Protocol parity with the reference engine's FRI parameters (rate 1/8,
cap height 4, 16 PoW bits, 28 query rounds, constant-arity-16 folds —
SURVEY.md §2b row standard_recursion_config); transcript and encoding
details are this stack's own normative spec (documented inline).

The prover side (commit, fold, PoW, query gathers) runs on the device in
plonk/device_prover.py; this module keeps the verifier and the helpers
both sides share.

Batched opening: given oracles committed over the LDE coset and claimed
openings at points z_b, the FRI input polynomial is
    G(X) = sum_b ( F_b(X) - F_b(z_b) ) / (X - z_b),
    F_b(X) = sum_{i in batch b} alpha^{off_b + i} f_i(X)
with one global alpha and offsets continuing across batches.
"""

from __future__ import annotations

import numpy as np

from ..ops import goldilocks as gl
from ..ops import ntt as ntt_mod
from ..ops import poseidon as pos
from ..ops.transcript import Challenger
from .proof import FriProof

# -- extension helpers (vectorized numpy over (..., 2)) ---------------------


def ext_inverse_vec(a: np.ndarray) -> np.ndarray:
    a0, a1 = a[..., 0], a[..., 1]
    norm = gl.sub(gl.mul(a0, a0), gl.mul(np.uint64(7), gl.mul(a1, a1)))
    inv = gl.batch_inverse(norm).reshape(norm.shape)
    return np.stack([gl.mul(a0, inv), gl.mul(gl.neg(a1), inv)], axis=-1)


def ext_powers(base: np.ndarray, n: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] as (n, 2)."""
    out = np.zeros((n, 2), dtype=np.uint64)
    acc = gl.ext(np.uint64(1), np.uint64(0))
    for i in range(n):
        out[i] = acc
        acc = gl.ext_mul(acc, base)
    return out


def _modsum(a: np.ndarray, axis: int) -> np.ndarray:
    """Sum modulo p along `axis` by pairwise folding — log2(k) wide
    gl.add dispatches instead of k, and no u64 overflow."""
    a = np.moveaxis(a, axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        folded = gl.add(a[:half], a[half : 2 * half])
        a = (
            np.concatenate([folded, a[2 * half :]], axis=0)
            if n & 1
            else folded
        )
        n = a.shape[0]
    return a[0]


def _ext_powers_rows(x: np.ndarray, n: int) -> np.ndarray:
    """Per-row extension powers: x (Q, 2) -> (Q, n, 2) with
    out[q, t] = x[q]^t, via log2(n) vectorized doubling steps."""
    Q = x.shape[0]
    pows = np.zeros((Q, 1, 2), dtype=np.uint64)
    pows[:, 0, 0] = 1
    cur = x[:, None, :]  # x^(current length)
    while pows.shape[1] < n:
        pows = np.concatenate([pows, gl.ext_mul(pows, cur)], axis=1)
        cur = gl.ext_mul(cur, cur)
    return pows[:, :n]


def flatten_ext(v: np.ndarray) -> np.ndarray:
    """(..., k, 2) -> (..., 2k) interleaved [c0, c1, c0, c1, ...]."""
    return v.reshape(*v.shape[:-2], -1)


# -- commit phase -----------------------------------------------------------


def _layer_cap_height(cfg, num_leaves: int) -> int:
    return min(cfg.cap_height, max(0, num_leaves.bit_length() - 1))


def _fold_matrices(arity_bits: int):
    """iNTT matrix W[k, t] = omega_A^{-k t} / A for the arity-A coset."""
    A = 1 << arity_bits
    omega = ntt_mod.root_of_unity(arity_bits)
    omega_inv = pow(omega, gl.P - 2, gl.P)
    a_inv = pow(A, gl.P - 2, gl.P)
    W = np.empty((A, A), dtype=np.uint64)
    for k in range(A):
        for t in range(A):
            W[k, t] = pow(omega_inv, k * t, gl.P) * a_inv % gl.P
    return W


def verify_pow(challenger: Challenger, witness: int, bits: int) -> None:
    challenger.observe_element(witness)
    c = int(challenger.get_challenge())
    if c >> (64 - bits) != 0:
        raise VerificationError("FRI proof-of-work check failed")


class VerificationError(ValueError):
    pass


# -- query phase (prover) ---------------------------------------------------


def fri_verify(
    caps: list,  # per-oracle caps (verified membership targets)
    batch_spec: list,  # [(point_ext (2,), eval_ext (2,), col_ranges)] per batch
    proof: FriProof,
    degree_bits: int,
    common,
    challenger: Challenger,
    alpha: np.ndarray,
) -> None:
    """Verify the FRI opening proof.

    batch_spec: list of (z, reduced_claim) where reduced_claim is the
    alpha-combination (with global offsets) of the claimed openings of
    that batch; plus per-batch the oracle column layout is implied by
    `oracle_slices` below.
    """
    cfg = common.config.fri_config
    arities = cfg.reduction_arity_bits(degree_bits)
    lde_bits = degree_bits + cfg.rate_bits
    M0 = 1 << lde_bits

    # replay transcript: layer caps -> betas, final poly, pow, indices
    betas = []
    for cap in proof.commit_phase_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    challenger.observe_elements(proof.final_poly.ravel())
    verify_pow(challenger, proof.pow_witness, cfg.proof_of_work_bits)
    indices = challenger.get_indices(cfg.num_query_rounds, lde_bits)

    if len(proof.commit_phase_caps) != len(arities):
        raise VerificationError("wrong number of FRI layers")
    if proof.final_poly.shape[0] != 1 << (degree_bits - sum(arities)):
        raise VerificationError("wrong FRI final polynomial length")
    if len(proof.query_rounds) != cfg.num_query_rounds:
        raise VerificationError("wrong number of FRI query rounds")

    w0 = ntt_mod.root_of_unity(lde_bits)
    Q = len(indices)
    idx = np.array(indices, dtype=np.int64)

    # 1. initial oracle membership — batched per oracle across queries
    for o, cap in enumerate(caps):
        if any(len(q.initial.leaves) != len(caps) for q in proof.query_rounds):
            raise VerificationError("wrong number of initial oracles")
        leaves = np.stack([q.initial.leaves[o] for q in proof.query_rounds])
        depths = {len(q.initial.paths[o]) for q in proof.query_rounds}
        if len(depths) != 1:
            raise VerificationError("inconsistent merkle path depths")
        paths = _stack_paths([q.initial.paths[o] for q in proof.query_rounds])
        _batch_verify_merkle(leaves, idx, paths, cap)

    # 2. evaluate G at x0 — batched over queries
    x0 = gl.mul(
        np.uint64(gl.GENERATOR),
        ntt_mod.powers(w0, M0)[idx % M0],
    )  # (Q,)
    all_cols = np.stack(
        [np.concatenate(q.initial.leaves) for q in proof.query_rounds]
    )  # (Q, total_cols)
    value = np.zeros((Q, 2), dtype=np.uint64)
    x0_ext = np.stack([x0, np.zeros(Q, dtype=np.uint64)], axis=-1)
    for (z, reduced_claim, col_idx) in batch_spec:
        cols = all_cols[:, col_idx]  # (Q, S_b)
        # comb = sum_i cols[:, i] * alpha^i as ONE wide base*ext
        # product + a log-depth modular reduction (the per-column
        # Horner paid ~70 µs of dispatch overhead per step)
        apows = gl.ext_powers_vec(alpha, cols.shape[1])  # (S_b, 2)
        comb = _modsum(
            gl.mul(cols[:, :, None], apows[None, :, :]), axis=1
        )  # (Q, 2)
        num = gl.ext_sub(comb, np.broadcast_to(reduced_claim, (Q, 2)))
        den = gl.ext_sub(x0_ext, np.broadcast_to(z, (Q, 2)))
        value = gl.ext_add(value, gl.ext_mul(num, ext_inverse_vec(den)))

    # 3. fold through layers — batched over queries
    j = idx.copy()
    M = M0
    shift = gl.GENERATOR
    x = x0_ext.copy()
    for t, (ab, beta, cap) in enumerate(
        zip(arities, betas, proof.commit_phase_caps)
    ):
        A = 1 << ab
        jg = j % (M // A)
        k_in_group = j // (M // A)
        leaves = np.stack(
            [q.steps[t].leaf for q in proof.query_rounds]
        )  # (Q, A, 2)
        if not np.array_equal(leaves[np.arange(Q), k_in_group], value):
            raise VerificationError("FRI fold consistency check failed")
        paths = _stack_paths([q.steps[t].path for q in proof.query_rounds])
        _batch_verify_merkle(flatten_ext(leaves), jg, paths, cap)
        s_j = gl.mul(
            np.uint64(shift), ntt_mod.powers(w0, M0)[jg * (M0 // M) % M0]
        )  # (Q,)
        value = _fold_batch(leaves, ab, s_j, beta)
        j = jg
        M //= A
        shift = pow(shift, A, gl.P)
        for _ in range(ab):
            x = gl.ext_mul(x, x)

    # 4. final polynomial evaluation — batched over queries AND terms
    T = len(proof.final_poly)
    xp = _ext_powers_rows(x, T)  # (Q, T, 2)
    fp = _modsum(
        gl.ext_mul(xp, np.asarray(proof.final_poly)[None, :, :]), axis=1
    )
    if not np.array_equal(fp, value):
        raise VerificationError("FRI final polynomial check failed")


def _stack_paths(path_lists: list) -> np.ndarray:
    """list (len Q) of sibling lists -> (Q, depth, 4).

    One concatenate over the flattened sibling digests instead of Q+1
    np.stack calls (~2 ms of dispatch per verify at Q=28)."""
    Q = len(path_lists)
    depth = len(path_lists[0])
    if depth == 0:
        return np.zeros((Q, 0, 4), dtype=np.uint64)
    flat = np.concatenate(
        [sib for path in path_lists for sib in path]
    )
    return flat.reshape(Q, depth, 4)


def _batch_verify_merkle(
    leaves: np.ndarray, indices: np.ndarray, paths: np.ndarray, cap: np.ndarray
) -> None:
    """Verify Q merkle proofs at once: leaves (Q, w), indices (Q,),
    paths (Q, depth, 4), cap (2^h, 4)."""
    Q, w = leaves.shape
    if w <= 4:
        h = np.zeros((Q, 4), dtype=np.uint64)
        h[:, :w] = leaves
    else:
        h = pos.hash_no_pad_rows(leaves)
    depth = paths.shape[1]
    from .. import native

    walked = (
        native.poseidon_merkle_walk(h, indices, paths) if depth else h
    )
    if walked is not None:
        if not (cap[indices >> depth] == walked).all():
            raise VerificationError("merkle proof failed")
        return
    idx = indices.copy()
    for d in range(depth):
        sib = paths[:, d, :]
        left = np.where((idx & 1)[:, None].astype(bool), sib, h)
        right = np.where((idx & 1)[:, None].astype(bool), h, sib)
        h = pos.hash_no_pad_rows(np.concatenate([left, right], axis=1))
        idx >>= 1
    if not (cap[idx] == h).all():
        raise VerificationError("merkle proof failed")


def _fold_batch(
    leaves: np.ndarray, arity_bits: int, s_j: np.ndarray, beta: np.ndarray
) -> np.ndarray:
    """Fold Q coset groups (Q, arity, 2) with per-query shifts s_j (Q,)."""
    A = 1 << arity_bits
    Q = leaves.shape[0]
    W = _fold_matrices(arity_bits)
    # c[q, t] = sum_k leaves[q, k] * W[k, t]: one wide product + a
    # log-depth modular sum (the k-loop paid 2A dispatches)
    c = _modsum(
        gl.mul(leaves[:, :, None, :], W[None, :, :, None]), axis=1
    )  # (Q, A, 2)
    s_inv = gl.inverse(s_j)  # (Q,) — python-pow path at this size
    t_pows = np.empty((Q, A), dtype=np.uint64)
    acc = np.ones(Q, dtype=np.uint64)
    for t in range(A):
        t_pows[:, t] = acc
        acc = gl.mul(acc, s_inv)
    c = gl.mul(c, t_pows[..., None])
    # out = sum_t c[:, t] * beta^t, one wide ext product + modsum
    bpows = gl.ext_powers_vec(beta, A)  # (A, 2)
    return _modsum(gl.ext_mul(c, bpows[None, :, :]), axis=1)
