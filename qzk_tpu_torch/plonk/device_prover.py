"""Device-resident staged prove pipeline (torch; CUDA kernels on the card).

Same protocol as the JAX package's staged ``device_prove``
(qzk_tpu/plonk/device_prover.py), and byte-identical proofs: identical
transcripts, commitments and FRI queries.  Every heavy phase stays on
the device between transcript interactions:

  wires        -> [iNTT -> coset LDE -> Merkle levels]
  betas/gammas -> [permutation Zs -> LDE -> Merkle levels]
  alphas       -> [vanishing eval -> /Z_H -> quotient coeffs
                   -> LDE -> Merkle levels + degree check]
  zeta         -> [openings at zeta / g*zeta]
  fri alpha    -> [FRI input polynomial G]
  FRI commit:  per layer [leaves + levels] and [fold]
  PoW grind on the device; query-round data gathered on the device.

The host keeps the Fiat-Shamir challenger (ops/transcript.py) and
downloads only caps, openings, the FRI final polynomial and the query
rounds' leaves and paths.  Merkle hashing runs on the CUDA row sponge
(K1) and the PoW grind on the CUDA permutation (K2), through
ops/poseidon_cuda.py; every iNTT and coset LDE is the four-step
transform on the CUDA NTT kernel (K3), through ops/ntt_fourstep.py; the
rest is torch tensor code on int64 bit patterns
(ops/goldilocks_torch.py).  Under zero knowledge the wires, zs and
quotient leaves carry four salt columns each (the preprocessed tree
none), which the FRI batches skip and the query openings carry.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks_torch as gt
from ..ops import merkle as mk
from ..ops import ntt as ntt_mod
from ..ops import ntt_fourstep as nfs
from ..ops import poseidon_cuda as pc
from ..ops.transcript import Challenger
from . import fri as fri_mod
from .proof import (
    FriInitialProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    Openings,
    Proof,
    ProofWithPublicInputs,
)
from .vanishing import eval_vanishing_torch


@dataclass
class DeviceTree:
    """Merkle tree kept on the device: leaves (n, w), digest levels
    (levels[-1] = cap).  Only the rows a query asks for are
    downloaded."""

    leaves: torch.Tensor
    levels: list
    cap: np.ndarray  # host copy (2^h, 4)

    @classmethod
    def from_levels(cls, leaves, levels) -> "DeviceTree":
        return cls(leaves=leaves, levels=levels, cap=gt.to_u64(levels[-1]))

    def gather_queries(self, idx: np.ndarray):
        """(Q,) indices -> (leaves (Q, w), paths (Q, depth, 4)) on the
        device: each row and its siblings through the non-cap levels."""
        i = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.leaves.device)
        rows = self.leaves[i]
        sibs = [self.levels[l][(i >> l) ^ 1] for l in range(len(self.levels) - 1)]
        if not sibs:
            return rows, torch.zeros((i.shape[0], 0, 4), dtype=torch.int64, device=i.device)
        return rows, torch.stack(sibs, dim=1)


class DeviceProverContext:
    """Per-circuit device constants and pipeline stages.

    Built on the first prove of a circuit on a device and cached on the
    ProverOnlyCircuitData; later proofs reuse the uploaded and derived
    arrays."""

    def __init__(self, common, prover_only, device: torch.device):
        self.common = common
        self.device = device
        cfg = common.config
        fri_cfg = cfg.fri_config
        N = common.degree
        lde_size = common.lde_size
        rate_bits = fri_cfg.rate_bits

        def up(a):
            return gt.from_u64(np.ascontiguousarray(a), device)

        # --- uploaded circuit constants: the (S, N) coefficient form and
        # the small per-circuit vectors; the preprocessed LDE and its
        # Merkle tree are derived on the device
        self.pre_coeffs = up(ntt_mod.intt_np(prover_only.preprocessed_values))
        self.sigma_enc = up(prover_only.sigma_encodings.T)  # (N, 80)
        coset_points = gl.mul(
            np.uint64(gl.GENERATOR),
            ntt_mod.powers(ntt_mod.root_of_unity(common.lde_bits), lde_size),
        )
        self.coset_points = up(coset_points)
        z_h = gl.sub(gl.exp(coset_points[: 1 << rate_bits], N), np.uint64(1))
        self.z_h_inv_full = up(np.tile(gl.inverse(z_h), lde_size >> rate_bits))
        self.l1 = up(
            gl.mul(
                np.tile(z_h, lde_size >> rate_bits),
                gl.batch_inverse(
                    gl.mul(np.uint64(N), gl.sub(coset_points, np.uint64(1)))
                ),
            )
        )
        self.shift_inv_pows = up(
            ntt_mod.powers(pow(gl.GENERATOR, gl.P - 2, gl.P), lde_size)
        )
        self.k_is = up(common.k_is)
        g_pows = up(ntt_mod.powers(common.subgroup_generator(), N))
        # four-step NTT plans (K3)
        self.ntt_n = nfs.get_fourstep_cuda_plan(common.degree_bits)
        self.ntt_m = nfs.get_fourstep_cuda_plan(common.lde_bits)
        self.shift_n = up(ntt_mod.powers(gl.GENERATOR, N))

        # --- one-time derivation of the big per-circuit arrays ----------
        self.pre_lde = nfs.coset_lde(self.pre_coeffs, rate_bits, self.shift_n)
        self.pre_tree = self._commit_leaves(self.pre_lde.T)
        if not (self.pre_tree.cap == prover_only.preprocessed_tree.cap).all():
            raise RuntimeError("device-derived preprocessed cap != host cap")
        self.id_enc = gt.mul(g_pows[:, None], self.k_is[None, :])

        # --- wire-matrix assembly as a gather: wm.flat[i] =
        # values_ext[gather[i]], unset slots pointing at an appended zero
        W = cfg.num_wires
        flat = (
            np.asarray(prover_only.slot_rows, dtype=np.int64) * W
            + np.asarray(prover_only.slot_cols, dtype=np.int64)
        )
        self._n_vals = int(prover_only.plan.num_targets)
        self._n_used = len(prover_only.rows)
        gather = np.full(N * W, self._n_vals, dtype=np.int64)
        gather[flat] = np.asarray(prover_only.slot_targets, dtype=np.int64)
        self._wire_gather = torch.as_tensor(gather, device=device)

    # -- stages ---------------------------------------------------------------

    def assemble_wires(self, values: np.ndarray, blind=None) -> torch.Tensor:
        """Host witness values -> (N, 135) wire matrix on the device;
        rows n_used: take the zk blind block when there is one."""
        values = np.asarray(values, dtype=np.uint64)
        if len(values) != self._n_vals:
            raise ValueError(
                f"witness value count {len(values)} != plan {self._n_vals}"
            )
        v = gt.from_u64(np.concatenate([values, np.zeros(1, np.uint64)]), self.device)
        N, W = self.common.degree, self.common.config.num_wires
        wm = v[self._wire_gather].reshape(N, W)
        if blind is not None:
            wm[self._n_used :] = blind
        return wm

    def _commit_leaves(self, lde_t: torch.Tensor, salt=None) -> DeviceTree:
        """Merkle tree over the rows of `lde_t`, with the zk salt's four
        columns appended to each leaf when there is one."""
        leaves = lde_t.contiguous() if salt is None else torch.cat([lde_t, salt], dim=1)
        cap_height = self.common.config.fri_config.cap_height
        return DeviceTree.from_levels(leaves, mk.build_merkle_levels(leaves, cap_height))

    def commit(self, values: torch.Tensor, salt=None):
        """(S, N) subgroup values -> coeffs, (S, 8N) coset LDE, tree
        (salted leaves under zero knowledge)."""
        common = self.common
        coeffs = self.ntt_n.intt(values)
        lde = nfs.coset_lde(coeffs, common.config.fri_config.rate_bits, self.shift_n)
        return coeffs, lde, self._commit_leaves(lde.T, salt)

    def zs_stage(self, w_routed, betas, gammas):
        """(N, 80) routed wires -> (num_zs_pp, N) Z / partial-product
        columns.  Chunk products reduce as a halving tree: associativity
        is exact in the field, so the values equal the sequential
        order's."""
        common = self.common
        cfg = common.config
        chunk, n_chunks = common.chunk_size, common.num_chunks
        rows = []
        for c in range(cfg.num_challenges):
            beta, gamma = betas[c], gammas[c]
            nums = gt.add(gt.add(w_routed, gt.mul(beta, self.id_enc)), gamma)
            dens = gt.add(gt.add(w_routed, gt.mul(beta, self.sigma_enc)), gamma)
            ratios = gt.mul(nums, gt.batch_inverse_axis(dens, axis=1))
            if cfg.num_routed_wires == n_chunks * chunk:
                t = ratios.reshape(-1, n_chunks, chunk)
                while t.shape[-1] > 1:
                    if t.shape[-1] % 2:
                        t = torch.cat([t, torch.ones_like(t[..., :1])], dim=-1)
                    t = gt.mul(t[..., 0::2], t[..., 1::2])
                chunk_prods = [t[:, k, 0] for k in range(n_chunks)]
            else:  # ragged tail chunk: sequential
                chunk_prods = []
                for k in range(n_chunks):
                    lo, hi = k * chunk, min((k + 1) * chunk, cfg.num_routed_wires)
                    acc = ratios[:, lo]
                    for j in range(lo + 1, hi):
                        acc = gt.mul(acc, ratios[:, j])
                    chunk_prods.append(acc)
            row_ratio = chunk_prods[0]
            for k in range(1, n_chunks):
                row_ratio = gt.mul(row_ratio, chunk_prods[k])
            z = gt.prefix_prod_exclusive(row_ratio)
            rows.append(z)
            cum = z
            for k in range(common.num_partial_products):
                cum = gt.mul(cum, chunk_prods[k])
                rows.append(cum)
        return torch.stack(rows)

    def quotient_stage(self, wires_lde, zs_lde, pi_hash, betas, gammas, alphas):
        common = self.common
        cfg = common.config
        N = common.degree
        n_pp = common.num_partial_products
        n_sel, n_const = common.num_selectors, cfg.num_constants
        rate = 1 << cfg.fri_config.rate_bits
        zs_at, zs_right, partials_at = [], [], []
        for c in range(cfg.num_challenges):
            base = c * (1 + n_pp)
            zs_at.append(zs_lde[base])
            zs_right.append(torch.roll(zs_lde[base], -rate))
            partials_at.append([zs_lde[base + 1 + k] for k in range(n_pp)])
        pre = self.pre_lde
        vanishing = eval_vanishing_torch(
            common, self.coset_points, wires_lde,
            pre[:n_sel], pre[n_sel : n_sel + n_const], pre[n_sel + n_const :],
            zs_at, zs_right, partials_at, pi_hash, betas, gammas, alphas,
            self.l1, self.k_is,
        )
        deg_cap = cfg.max_quotient_degree_factor * N
        qv = gt.mul(torch.stack(vanishing), self.z_h_inv_full)
        q_coeffs = gt.mul(self.ntt_m.intt(qv), self.shift_inv_pows)
        tail_ok = bool((q_coeffs[:, deg_cap - N :] == 0).all())
        quotient_coeffs = q_coeffs[:, :deg_cap].reshape(-1, N)
        quotient_lde = nfs.coset_lde(quotient_coeffs, cfg.fri_config.rate_bits, self.shift_n)
        return quotient_coeffs, quotient_lde, tail_ok

    def openings_stage(self, wires_coeffs, zs_coeffs, quotient_coeffs, zeta, zeta_right):
        N = self.common.degree
        pows = gt.ext_powers(zeta, N)
        pows_r = gt.ext_powers(zeta_right, N)

        def eval_polys_ext(coeffs, p):
            c0 = gt.sum_mod(gt.mul(coeffs, p[None, :, 0]), axis=1)
            c1 = gt.sum_mod(gt.mul(coeffs, p[None, :, 1]), axis=1)
            return torch.stack([c0, c1], dim=-1)

        return (
            eval_polys_ext(self.pre_coeffs, pows),
            eval_polys_ext(wires_coeffs, pows),
            eval_polys_ext(zs_coeffs, pows),
            eval_polys_ext(quotient_coeffs, pows),
            eval_polys_ext(zs_coeffs, pows_r),
        )

    def _fri_input_one(self, lde_rows, apows, reduced_claim, z):
        """alpha-combined (F(x) - F(z)) / (x - z) over the coset."""
        comb0 = gt.sum_mod(gt.mul(lde_rows, apows[:, 0:1]), axis=0)
        comb1 = gt.sum_mod(gt.mul(lde_rows, apows[:, 1:2]), axis=0)
        comb = torch.stack([comb0, comb1], dim=-1)
        num = gt.ext_sub(comb, reduced_claim.expand(comb.shape))
        den = torch.stack(
            [
                gt.sub(self.coset_points, z[0]),
                gt.neg(z[1]).expand(self.common.lde_size),
            ],
            dim=-1,
        )
        return gt.ext_mul(num, gt.ext_inverse_vec(den))

    def fri_input_stage(self, wires_lde, zs_lde, quotient_lde, apows_all,
                        claim_all, zeta, apows_zs, claim_zs, zeta_right):
        all_lde = torch.cat([self.pre_lde, wires_lde, zs_lde, quotient_lde])
        G = self._fri_input_one(all_lde, apows_all, claim_all, zeta)
        G2 = self._fri_input_one(zs_lde, apows_zs, claim_zs, zeta_right)
        return gt.ext_add(G, G2)

    def fri_layer(self, M: int, arity_bits: int, shift: int, cap_h: int):
        """(commit_layer, fold_layer) for one FRI layer shape."""
        A = 1 << arity_bits
        W = gt.from_u64(fri_mod._fold_matrices(arity_bits), self.device)  # (A, A)
        w_M = ntt_mod.root_of_unity(M.bit_length() - 1)
        s_j_inv = gt.from_u64(
            gl.mul(
                np.uint64(pow(shift, gl.P - 2, gl.P)),
                ntt_mod.powers(pow(w_M, gl.P - 2, gl.P), M // A),
            ),
            self.device,
        )

        def group(values):
            # (M, 2) -> (M/A, A, 2): points sharing x^A (stride M/A)
            return values.reshape(A, M // A, 2).movedim(0, 1)

        def commit_layer(values) -> DeviceTree:
            leaves = group(values).reshape(M // A, 2 * A).contiguous()
            return DeviceTree.from_levels(leaves, mk.build_merkle_levels(leaves, cap_h))

        def fold_layer(values, beta):
            groups = group(values)  # (M/A, A, 2)
            c = gt.zeros((M // A, A, 2), self.device)
            for k in range(A):
                c = gt.add(c, gt.mul(groups[:, k, None, :], W[k][None, :, None]))
            t_pows = []
            acc = gt.ones(M // A, self.device)
            for _ in range(A):
                t_pows.append(acc)
                acc = gt.mul(acc, s_j_inv)
            c = gt.mul(c, torch.stack(t_pows, dim=1)[..., None])
            out = gt.zeros((M // A, 2), self.device)
            beta_b = beta.expand(M // A, 2)
            for t in reversed(range(A)):
                out = gt.ext_add(gt.ext_mul(out, beta_b), c[:, t])
            return out

        return commit_layer, fold_layer, group

    def grind_pow(self, challenger: Challenger, bits: int) -> int:
        """Batched PoW grind on the permutation kernel (K2): the first
        candidate in order whose challenge has `bits` leading zeros,
        identical to fri.grind_pow.  Batches of 2^18 candidates on the
        card (2^12 for the plain version on the CPU)."""
        B = 1 << (18 if self.device.type == "cuda" else 12)
        pending = list(challenger.input_buf)
        n_pending = len(pending)
        base = np.array(challenger.state, dtype=np.uint64)
        base[:n_pending] = np.array(pending, dtype=np.uint64)
        states0 = gt.from_u64(base, self.device).expand(B, 12).clone()
        lane = torch.arange(B, dtype=torch.int64, device=self.device)
        start = 0
        while True:
            states = states0.clone()
            states[:, n_pending] = lane + start
            out = pc.permute(states)
            ok = gt.shr(out[:, 7], 64 - bits) == 0
            hits = torch.nonzero(ok)
            if hits.numel():
                found = start + int(hits[0, 0])
                break
            start += B
        challenger.observe_element(found)
        check = int(challenger.get_challenge())
        if check >> (64 - bits) != 0:
            raise RuntimeError("PoW self-check failed")
        return found


# LRU over live device contexts: each context pins its circuit's
# preprocessed LDE, tree and derived arrays in device memory, and an
# aggregation tree proves one more circuit a level.
# Keeping at most QZK_CTX_LIMIT contexts resident turns that into
# eviction and a rebuild.  Entries: (id(ctxs), key, ctxs, common) in
# least-recent-first order; ctxs is the owning prover_only's
# _torch_ctxs.
_CTX_LRU: list = []
_CTX_LOCK = threading.Lock()


def _ctx_limit() -> int:
    try:
        return max(1, int(os.environ.get("QZK_CTX_LIMIT", "3")))
    except ValueError:
        return 3


def _lru_touch(ctxs, key, common) -> None:
    entry = (id(ctxs), key)
    for i, (eid, ekey, _, _) in enumerate(_CTX_LRU):
        if (eid, ekey) == entry:
            _CTX_LRU.append(_CTX_LRU.pop(i))
            return
    _CTX_LRU.append((id(ctxs), key, ctxs, common))


def _evict_down_to(n_keep: int) -> None:
    while len(_CTX_LRU) > n_keep:
        _, key, ctxs, _ = _CTX_LRU.pop(0)
        ctxs.pop(key, None)  # drop the refs; torch frees the memory


def context_device(device) -> torch.device:
    """`device` with its index: a bare "cuda" is the current card, so
    that "cuda" and "cuda:0" share one context."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_context(common, prover_only, device) -> DeviceProverContext:
    """The circuit's context on `device`, built at first use.

    Contexts are keyed by the device with its index, so that concurrent
    chunk proves on several cards (the aggregator's fan-out) each get
    arrays on their own card.  A process-wide LRU bounds the resident
    contexts (see _CTX_LRU above); when building one runs out of device
    memory, every other context is evicted and the build retried once on
    the same device."""
    dev = context_device(device)
    key = str(dev)
    ctxs = getattr(prover_only, "_torch_ctxs", None)
    if ctxs is None:
        ctxs = prover_only._torch_ctxs = {}
    ctx = ctxs.get(key)
    if ctx is None:
        with _CTX_LOCK:
            _evict_down_to(_ctx_limit() - 1)
        try:
            ctx = DeviceProverContext(common, prover_only, dev)
        except torch.cuda.OutOfMemoryError:
            pass  # retried below, once the handler has let go of the failed build
        if ctx is None:
            with _CTX_LOCK:
                _evict_down_to(0)
            ctx = DeviceProverContext(common, prover_only, dev)
        ctxs[key] = ctx
    with _CTX_LOCK:
        _lru_touch(ctxs, key, common)
    return ctx


def _assemble_query_rounds(groups, arities, oracles, layer_values, layer_trees, indices):
    """Device gathers for all oracles and FRI layers, then one download;
    returns the per-round proof structures."""
    idx = np.array(indices, dtype=np.int64)
    oracle_data = [tuple(gt.to_u64(a) for a in t.gather_queries(idx)) for t in oracles]
    step_data = []
    j = idx
    for t, ab in enumerate(arities):
        A = 1 << ab
        M = layer_values[t].shape[0]
        jg = j % (M // A)
        grouped = groups[t](layer_values[t])[torch.as_tensor(jg, device=layer_values[t].device)]
        step_data.append((gt.to_u64(grouped), gt.to_u64(layer_trees[t].gather_queries(jg)[1])))
        j = jg
    return _rounds_from_data(oracle_data, step_data, len(indices))


def _rounds_from_data(oracle_data, step_data, Q):
    """Host proof structures from downloaded query-gather arrays:
    oracle_data = [(rows (Q, w), paths (Q, depth, 4))] per oracle,
    step_data = [(grouped (Q, A, 2), paths (Q, depth, 4))] per layer."""
    rounds = []
    for q in range(Q):
        leaves_q = [np.asarray(rows[q], dtype=np.uint64) for rows, _ in oracle_data]
        paths_q = [
            [np.asarray(paths[q, d], dtype=np.uint64) for d in range(paths.shape[1])]
            for _, paths in oracle_data
        ]
        steps = [
            FriQueryStep(
                leaf=np.asarray(leaf_rows[q], dtype=np.uint64),
                path=[np.asarray(paths[q, d], dtype=np.uint64) for d in range(paths.shape[1])],
            )
            for leaf_rows, paths in step_data
        ]
        rounds.append(
            FriQueryRound(
                initial=FriInitialProof(leaves=leaves_q, paths=paths_q),
                steps=steps,
            )
        )
    return rounds


def device_prove(common, prover_only, values, blind_block, public_inputs, pi_hash,
                 fresh_salt, device: torch.device, timer=None) -> ProofWithPublicInputs:
    """Steps 2-5 of the prove pipeline on `device`, from the host
    witness values.  Called by plonk.prover.prove, which passes the zk
    blind block (or None) and fresh_salt(n_leaves), the next (n, 4)
    salt of the blinding stream (None without zero knowledge): drawn
    for the wires, the zs and the quotient, in that order."""
    cfg = common.config
    fri_cfg = cfg.fri_config
    mark = timer.mark if timer is not None else (lambda name: None)
    ctx = get_context(common, prover_only, device)

    def dev(a):
        return gt.from_u64(np.asarray(a, dtype=np.uint64), device)

    # 2. commit wires ---------------------------------------------------------
    wire_matrix = ctx.assemble_wires(values, blind_block)  # (N, 135)
    wires_coeffs, wires_lde, wires_tree = ctx.commit(
        wire_matrix.T, fresh_salt(common.lde_size)
    )
    mark("wires")

    challenger = Challenger()
    challenger.observe_elements(common.circuit_digest)
    challenger.observe_elements(pi_hash)
    challenger.observe_cap(wires_tree.cap)
    betas = challenger.get_n_challenges(cfg.num_challenges)
    gammas = challenger.get_n_challenges(cfg.num_challenges)

    # 3. permutation argument -------------------------------------------------
    zs_pp = ctx.zs_stage(
        wire_matrix[:, : cfg.num_routed_wires], dev(betas), dev(gammas)
    )
    zs_coeffs, zs_lde, zs_tree = ctx.commit(zs_pp, fresh_salt(common.lde_size))
    mark("zs")
    challenger.observe_cap(zs_tree.cap)
    alphas = challenger.get_n_challenges(cfg.num_challenges)

    # 4. quotient -------------------------------------------------------------
    quotient_coeffs, quotient_lde, tail_ok = ctx.quotient_stage(
        wires_lde, zs_lde, dev(pi_hash), dev(betas), dev(gammas), dev(alphas)
    )
    if not tail_ok:
        raise ValueError(
            "constraints unsatisfied: quotient degree overflow "
            "(witness does not satisfy the circuit)"
        )
    quotient_tree = ctx._commit_leaves(quotient_lde.T, fresh_salt(common.lde_size))
    mark("quotient")
    challenger.observe_cap(quotient_tree.cap)
    zeta = challenger.get_extension_challenge()

    # 5. openings -------------------------------------------------------------
    g = np.uint64(common.subgroup_generator())
    zeta_right = gl.ext_mul(zeta, gl.ext(g, np.uint64(0)))
    opened = ctx.openings_stage(
        wires_coeffs, zs_coeffs, quotient_coeffs, dev(zeta), dev(zeta_right)
    )
    openings = Openings(
        preprocessed=gt.to_u64(opened[0]),
        wires=gt.to_u64(opened[1]),
        zs_partial=gt.to_u64(opened[2]),
        quotient=gt.to_u64(opened[3]),
        zs_partial_right=gt.to_u64(opened[4]),
    )
    mark("openings")
    for _tag, vals in openings.batches():
        challenger.observe_elements(vals.ravel())
    fri_alpha = challenger.get_extension_challenge()

    # FRI input polynomial ------------------------------------------------------
    zeta_claims = np.concatenate(
        [openings.preprocessed, openings.wires, openings.zs_partial, openings.quotient]
    )
    apows_all = gl.ext_powers_vec(fri_alpha, zeta_claims.shape[0])
    apows_zs = gl.ext_powers_vec(fri_alpha, openings.zs_partial_right.shape[0])

    def reduce_claims(claims):
        rc = np.zeros(2, dtype=np.uint64)
        for i in range(claims.shape[0] - 1, -1, -1):
            rc = gl.ext_mul(rc, fri_alpha)
            rc = gl.ext_add(rc, claims[i])
        return rc

    G = ctx.fri_input_stage(
        wires_lde, zs_lde, quotient_lde,
        dev(apows_all), dev(reduce_claims(zeta_claims)), dev(zeta),
        dev(apows_zs), dev(reduce_claims(openings.zs_partial_right)), dev(zeta_right),
    )
    mark("fri input")

    # FRI commit phase ----------------------------------------------------------
    arities = fri_cfg.reduction_arity_bits(common.degree_bits)
    shift = gl.GENERATOR
    values_f = G
    layer_trees, layer_values, groups = [], [], []
    for ab in arities:
        A = 1 << ab
        M = values_f.shape[0]
        cap_h = fri_mod._layer_cap_height(fri_cfg, M // A)
        commit_layer, fold_layer, group = ctx.fri_layer(M, ab, shift, cap_h)
        tree = commit_layer(values_f)
        challenger.observe_cap(tree.cap)
        beta = challenger.get_extension_challenge()
        layer_trees.append(tree)
        layer_values.append(values_f)
        groups.append(group)
        values_f = fold_layer(values_f, dev(beta))
        shift = pow(shift, A, gl.P)
    final_values = gt.to_u64(values_f)
    M = final_values.shape[0]
    coeffs = ntt_mod.intt_np(final_values.T).T
    s_inv_pows = ntt_mod.powers(pow(shift, gl.P - 2, gl.P), M)
    coeffs = gl.mul(coeffs, s_inv_pows[:, None])
    final_len = 1 << max(0, common.degree_bits - sum(arities))
    if not (coeffs[final_len:] == 0).all():
        raise RuntimeError("FRI final poly degree too high")
    final_poly = coeffs[:final_len]
    challenger.observe_elements(final_poly.ravel())
    pow_witness = ctx.grind_pow(challenger, fri_cfg.proof_of_work_bits)
    mark("fri layers + pow")

    # query rounds ----------------------------------------------------------------
    indices = challenger.get_indices(fri_cfg.num_query_rounds, common.lde_bits)
    oracles = [ctx.pre_tree, wires_tree, zs_tree, quotient_tree]
    rounds = _assemble_query_rounds(
        groups, arities, oracles, layer_values, layer_trees, indices
    )
    mark("queries")

    proof = Proof(
        wires_cap=wires_tree.cap,
        zs_partial_cap=zs_tree.cap,
        quotient_cap=quotient_tree.cap,
        openings=openings,
        fri=FriProof(
            commit_phase_caps=[t.cap for t in layer_trees],
            final_poly=final_poly,
            pow_witness=pow_witness,
            query_rounds=rounds,
        ),
    )
    return ProofWithPublicInputs(proof=proof, public_inputs=public_inputs)
