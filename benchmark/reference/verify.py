"""A plain verifier of the port's proofs: the Fiat-Shamir transcript, the
vanishing identity at zeta, the batched FRI opening (Merkle membership of
every opened leaf, fold consistency, the final polynomial) and the
proof-of-work.  Many proofs of one circuit are checked together: their
transcripts and Merkle paths share each numpy call.

The protocol it checks (the port's, which is the JAX package's):
- transcript: observe the circuit digest and H(public inputs); the wires
  cap -> betas, gammas; the zs and partial-products cap -> alphas; the
  quotient cap -> zeta; the openings at zeta, then at g*zeta -> the FRI
  alpha; each FRI layer cap -> its beta; the final polynomial; the PoW
  witness -> one challenge whose top pow_bits bits are zero; then the
  query indices;
- the vanishing polynomial: per gate (in selector order), each
  constraint times the gate's selector; per chunk of the permutation
  argument, rho_{k+1} * prod(den) - rho_k * prod(num); L1 * (Z - 1);
  combined with each alpha, and equal to Z_H(zeta) times the quotient
  chunks recombined with zeta^N;
- FRI: oracles committed over the coset 7 * <w> of the LDE domain, leaves
  at the drawn index in natural order, four salt columns an oracle under
  zero knowledge (outside the batches); the input polynomial
  sum_b (F_b(x) - F_b(z_b)) / (x - z_b) with alpha's powers from 0 in each
  batch; folds of arity 2^ab by the inverse DFT of the coset, scaled by
  the coset shift's inverse powers and combined with beta's powers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import field as F
from . import gates as G
from . import poseidon as pos
from .challenger import Challenger
from .formats import Common, Proof, VerifierKey

P = F.P
FAILED_POW = "proof of work"


@dataclass
class Transcript:
    pi_hash: np.ndarray  # (K, 4)
    betas: np.ndarray  # (K, challenges)
    gammas: np.ndarray
    alphas: np.ndarray
    zeta: np.ndarray  # (K, 2)
    fri_alpha: np.ndarray  # (K, 2)
    fri_betas: list  # per layer, (K, 2)
    pow_ok: np.ndarray  # (K,) bool
    indices: np.ndarray  # (K, queries)
    duplexes: int  # permutations of one transcript


def transcript(c: Common, vk: VerifierKey, proofs: list) -> Transcript:
    """Replay the transcripts of proofs of one circuit, all at once."""
    K = len(proofs)
    ch = Challenger(K)
    ch.observe(np.broadcast_to(vk.circuit_digest, (K, 4)))
    pi_hash = pos.sponge_rows(np.stack([p.public_inputs for p in proofs]))
    ch.observe(pi_hash)

    def cap(i):
        return np.stack([p.caps[i].ravel() for p in proofs])

    ch.observe(cap(0))
    betas, gammas = ch.challenges(c.num_challenges), ch.challenges(c.num_challenges)
    ch.observe(cap(1))
    alphas = ch.challenges(c.num_challenges)
    ch.observe(cap(2))
    zeta = ch.ext_challenge()
    for keys in (("preprocessed", "wires", "zs", "quotient"), ("zs_right",)):
        ch.observe(np.stack([np.concatenate([p.openings[k] for k in keys]).ravel()
                             for p in proofs]))
    fri_alpha = ch.ext_challenge()
    fri_betas = []
    for t in range(len(c.arities())):
        ch.observe(np.stack([p.layer_caps[t].ravel() for p in proofs]))
        fri_betas.append(ch.ext_challenge())
    ch.observe(np.stack([p.final_poly.ravel() for p in proofs]))
    ch.observe(np.array([[p.pow_witness] for p in proofs], dtype=np.uint64))
    pow_ok = (ch.challenge() >> np.uint64(64 - c.pow_bits)) == 0
    mask = np.uint64((1 << c.lde_bits) - 1)
    indices = (ch.challenges(c.num_queries) & mask).astype(np.int64)
    return Transcript(pi_hash, betas, gammas, alphas, zeta, fri_alpha, fri_betas,
                      pow_ok, indices, ch.duplexes)


def _pair(v) -> tuple:
    return (int(v[0]), int(v[1]))


def vanishing_holds(c: Common, proof: Proof, tr: Transcript, k: int) -> bool:
    """The vanishing identity at zeta for proof k of the transcript."""
    o = {name: [_pair(v) for v in arr] for name, arr in proof.openings.items()}
    zeta = _pair(tr.zeta[k])
    n_sel = len(c.gates)
    sel = o["preprocessed"][:n_sel]
    consts = o["preprocessed"][n_sel : n_sel + c.num_constants]
    sigmas = o["preprocessed"][n_sel + c.num_constants :]
    wires = o["wires"]
    pi_hash = [(int(h), 0) for h in tr.pi_hash[k]]
    N = 1 << c.degree_bits
    zeta_n = F.e_pow(zeta, N)
    z_h = F.e_sub(zeta_n, (1, 0))
    l1 = F.e_mul(z_h, F.e_inv(F.e_mul((N % P, 0), F.e_sub(zeta, (1, 0)))))

    gate_terms = []
    for s, gid in enumerate(c.gates):
        gate_terms.extend(F.e_mul(sel[s], t) for t in G.constraints(gid, wires, consts, pi_hash))
    per_challenge = c.num_chunks
    for ci in range(c.num_challenges):
        beta, gamma = (int(tr.betas[k, ci]), 0), (int(tr.gammas[k, ci]), 0)
        zs = o["zs"][ci * per_challenge : (ci + 1) * per_challenge]
        z_right = o["zs_right"][ci * per_challenge]
        rhos = zs + [z_right]
        terms = list(gate_terms)
        for chunk in range(c.num_chunks):
            lo = chunk * c.chunk_size
            num, den = (1, 0), (1, 0)
            for j in range(lo, min(lo + c.chunk_size, c.num_routed_wires)):
                kx = F.e_mul((c.k_is[j], 0), zeta)
                num = F.e_mul(num, F.e_add(F.e_add(wires[j], F.e_mul(beta, kx)), gamma))
                den = F.e_mul(den, F.e_add(F.e_add(wires[j], F.e_mul(beta, sigmas[j])), gamma))
            terms.append(F.e_sub(F.e_mul(rhos[chunk + 1], den), F.e_mul(rhos[chunk], num)))
        terms.append(F.e_mul(l1, F.e_sub(zs[0], (1, 0))))
        alpha = (int(tr.alphas[k, ci]), 0)
        acc = (0, 0)
        for t in reversed(terms):
            acc = F.e_add(F.e_mul(acc, alpha), t)
        quot = (0, 0)
        q = c.quotient_degree_factor
        for t in reversed(range(q)):
            quot = F.e_add(F.e_mul(quot, zeta_n), o["quotient"][ci * q + t])
        if acc != F.e_mul(z_h, quot):
            return False
    return True


def _fold_matrix(ab: int) -> list:
    """W[k][t] = omega^(-k t) / A on the arity-A coset."""
    A = 1 << ab
    w_inv = F.inv(F.root_of_unity(ab))
    a_inv = F.inv(A)
    return [[pow(w_inv, k * t, P) * a_inv % P for t in range(A)] for k in range(A)]


def _fri_values(c: Common, proof: Proof, tr: Transcript, k: int):
    """The FRI input polynomial at each query's point, folded layer by
    layer.  Returns (consistent, per-layer (leaf rows, leaf indices)):
    consistent is False when a layer's opened coset does not hold the
    folded value or the final polynomial disagrees."""
    lde_bits = c.lde_bits
    M0 = 1 << lde_bits
    w0 = F.root_of_unity(lde_bits)
    idx = [int(i) for i in tr.indices[k]]
    fa = _pair(tr.fri_alpha[k])
    zeta = _pair(tr.zeta[k])
    g_zeta = F.e_mul(zeta, (F.root_of_unity(c.degree_bits), 0))
    S, nw, nz, nq, salt = c.num_preprocessed, c.num_wires, c.num_zs, c.num_quotient, c.salt
    o = proof.openings
    cols_zeta = (list(range(S)) + [S + i for i in range(nw)]
                 + [S + nw + salt + i for i in range(nz)]
                 + [S + nw + salt + nz + salt + i for i in range(nq)])
    cols_right = [S + nw + salt + i for i in range(nz)]
    claims_zeta = np.concatenate([o["preprocessed"], o["wires"], o["zs"], o["quotient"]])
    batches = [(zeta, claims_zeta, cols_zeta), (g_zeta, o["zs_right"], cols_right)]
    all_cols = np.concatenate(proof.leaves, axis=1)  # (Q, total)

    values = [(0, 0)] * len(idx)
    for z, claims, cols in batches:
        claim = (0, 0)
        for v in claims[::-1]:
            claim = F.e_add(F.e_mul(claim, fa), _pair(v))
        apows = F.e_powers(fa, len(cols))
        comb = F.sum_mod(F.mul(all_cols[:, cols][:, :, None], apows[None]), axis=1)
        for q, i in enumerate(idx):
            x = F.MULTIPLICATIVE_GENERATOR * pow(w0, i, P) % P
            num = F.e_sub(_pair(comb[q]), claim)
            values[q] = F.e_add(values[q], F.e_mul(num, F.e_inv(F.e_sub((x, 0), z))))

    ok = True
    layers = []
    j, M, shift = list(idx), M0, F.MULTIPLICATIVE_GENERATOR
    for t, ab in enumerate(c.arities()):
        A = 1 << ab
        W = _fold_matrix(ab)
        beta = _pair(tr.fri_betas[t][k])
        bpows = [(1, 0)]
        for _ in range(A - 1):
            bpows.append(F.e_mul(bpows[-1], beta))
        leaves = proof.step_leaves[t]  # (Q, A, 2)
        jg = [i % (M // A) for i in j]
        for q in range(len(idx)):
            row = [_pair(v) for v in leaves[q]]
            if row[j[q] // (M // A)] != values[q]:
                ok = False
            s_inv = F.inv(shift * pow(w0, jg[q] * (M0 // M), P) % P)
            out, s_pow = (0, 0), 1
            for tt in range(A):
                ct0 = sum(row[kk][0] * W[kk][tt] for kk in range(A)) % P
                ct1 = sum(row[kk][1] * W[kk][tt] for kk in range(A)) % P
                ct = (ct0 * s_pow % P, ct1 * s_pow % P)
                out = F.e_add(out, F.e_mul(ct, bpows[tt]))
                s_pow = s_pow * s_inv % P
            values[q] = out
        layers.append((leaves.reshape(len(idx), -1), np.array(jg, dtype=np.int64)))
        j, M, shift = jg, M // A, pow(shift, A, P)
    fold_bits = sum(c.arities())
    fp = [_pair(v) for v in proof.final_poly]
    for q, i in enumerate(idx):
        x = (F.MULTIPLICATIVE_GENERATOR * pow(w0, i, P) % P, 0)
        x = F.e_pow(x, 1 << fold_bits)
        acc = (0, 0)
        for coeff in reversed(fp):
            acc = F.e_add(F.e_mul(acc, x), coeff)
        if acc != values[q]:
            ok = False
    return ok, layers


def _merkle_ok(leaf_rows: np.ndarray, indices: np.ndarray, paths: np.ndarray,
               caps: np.ndarray) -> np.ndarray:
    """Per lane, whether the leaf row's path reaches its cap entry.
    leaf_rows (L, w), indices (L,), paths (L, depth, 4), caps (L, n, 4)."""
    digests = pos.hash_rows(leaf_rows)
    top, left = pos.merkle_root_of_paths(digests, indices, paths)
    want = caps[np.arange(len(left)), left]
    return (top == want).all(axis=1)


def verify_batch(c: Common, vk: VerifierKey, proofs: list) -> list:
    """Check proofs of one circuit against its key.  Returns, per proof,
    None when it is valid, else the first check it fails."""
    K = len(proofs)
    if K == 0:
        return []
    tr = transcript(c, vk, proofs)
    reasons = [None if tr.pow_ok[k] else FAILED_POW for k in range(K)]
    for k, p in enumerate(proofs):
        if reasons[k] is None and not vanishing_holds(c, p, tr, k):
            reasons[k] = "vanishing identity"
    Q = c.num_queries
    lanes = np.repeat(np.arange(K), Q)
    flat_idx = tr.indices.reshape(-1)
    oracle_caps = [np.broadcast_to(vk.constants_sigmas_cap, (K,) + vk.constants_sigmas_cap.shape)]
    oracle_caps += [np.stack([p.caps[i] for p in proofs]) for i in range(3)]
    for o in range(4):
        ok = _merkle_ok(np.concatenate([p.leaves[o] for p in proofs]), flat_idx,
                        np.concatenate([p.paths[o] for p in proofs]), oracle_caps[o][lanes])
        for k in np.unique(lanes[~ok]):
            reasons[k] = reasons[k] or f"Merkle path of oracle {o}"
    fri = [_fri_values(c, p, tr, k) for k, p in enumerate(proofs)]
    for k, (consistent, _) in enumerate(fri):
        if not consistent:
            reasons[k] = reasons[k] or "FRI folding"
    for t in range(len(c.arities())):
        rows = np.concatenate([layers[t][0] for _, layers in fri])
        idx = np.concatenate([layers[t][1] for _, layers in fri])
        ok = _merkle_ok(rows, idx, np.concatenate([p.step_paths[t] for p in proofs]),
                        np.stack([p.layer_caps[t] for p in proofs])[lanes])
        for k in np.unique(lanes[~ok]):
            reasons[k] = reasons[k] or f"Merkle path of FRI layer {t}"
    return reasons


def verify_all(c: Common, vk: VerifierKey, proofs: list) -> list:
    """verify_batch over every proof, split in order among spawned
    processes, which import the reference alone: one a core this process
    may run on, at most 8 (a check runs after the window)."""
    processes = max(1, min(8, len(os.sched_getaffinity(0))))
    if processes <= 1 or len(proofs) < 2 * processes:
        return verify_batch(c, vk, proofs)
    import concurrent.futures
    import multiprocessing

    parts = [proofs[i::processes] for i in range(processes)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(processes, mp_context=ctx) as pool:
        done = list(pool.map(verify_batch, [c] * processes, [vk] * processes, parts))
    reasons = [None] * len(proofs)
    for i, part in enumerate(done):
        reasons[i::processes] = part
    return reasons
